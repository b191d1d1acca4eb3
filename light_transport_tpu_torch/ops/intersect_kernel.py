"""Cluster-culled brute-force intersection: the CUDA kernels K3 and K4 and
their plain PyTorch versions.

The counterpart of ``light_transport_tpu.ops.pallas.intersect_kernel``.
Each ray tests the triangles of the 512-triangle clusters whose bounding
box some ray of its 128-ray tile enters (the cull mask); the
BVH-reordered mesh (``Scene.with_bvh``) makes consecutive triangles
spatially compact, so coherent tiles admit few clusters.

* Möller–Trumbore is four dot products of the ray features
  ``[d, o x d, o, 1]`` with the packed triangle weights of
  :func:`pack_tri_weights` (det, u*det, v*det, t*det).  The plain version
  :func:`_cluster_hits` evaluates them element by element in one fixed
  order, and ``csrc/intersect_kernel.cu`` in the same order, so the two
  round alike.  All of it is FP32.
* Meshes of fewer than 16 clusters go through the dense kernel (K3,
  ``intersect_dense``): every cluster in turn, the rejected ones
  skipped.  Larger meshes go through the gather kernel (K4,
  ``intersect_gather``): each tile's list of admitted cluster ids.  The
  TPU kernel capped that list and chunked the rays for its 1 MB scalar
  memory; the lists here live in device memory, uncapped.
* Each ray keeps the nearest hit; at equal t the lowest triangle index
  wins (the TPU kernel broke exact ties by the lowest ``tri mod 128``).

``intersect_dense`` and ``intersect_gather`` launch their kernel for CUDA
tensors and run the plain version for CPU tensors; they have no other
path.  ``LAUNCHES`` counts the kernel launches of each.
"""

from __future__ import annotations

import ctypes

import torch

from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.ops.intersect import DET_EPS, Hit

RAY_TILE = 128
TRI_TILE = 512
BIG = 3.0e38  # "no hit" distance (finite, so the running minimum stays clean)
# at this many clusters or more the gather kernel (K4) runs, below it the
# dense kernel (K3)
GATHER_MIN_CLUSTERS = 16
# rays per piece of the cull mask: bounds its (rays, C, 3) temporaries to
# ~2^25 elements
_MASK_ELEMS = 1 << 25
# rays per piece of the plain version's (rays, 512) temporaries
_PLAIN_CHUNK = 8192

# kernel launches made through intersect_dense / intersect_gather (read and
# reset by callers)
LAUNCHES = {"intersect_dense": 0, "intersect_gather": 0}


def pack_tri_weights(mesh) -> torch.Tensor:
    """(16, 4, T_pad) f32 triangle weights (det, u_num, v_num, t_num
    columns), T padded to a multiple of TRI_TILE with det = 0 columns
    that never hit."""
    v0, e1, e2 = mesh.v0, mesh.e1, mesh.e2
    n2 = lm.cross(e1, e2)
    k0 = lm.dot(v0, n2)
    t = v0.shape[0]
    t_pad = -(-t // TRI_TILE) * TRI_TILE
    w = torch.zeros((16, 4, t_pad), dtype=torch.float32, device=v0.device)
    w[0:3, 0, :t] = -n2.T
    w[3:6, 1, :t] = e2.T
    w[0:3, 1, :t] = -lm.cross(e2, v0).T
    w[3:6, 2, :t] = -e1.T
    w[0:3, 2, :t] = -lm.cross(v0, e1).T
    w[6:9, 3, :t] = n2.T
    w[9, 3, :t] = -k0
    return w


def cluster_weights(tri_weights: torch.Tensor) -> torch.Tensor:
    """(C, 16, 4 * TRI_TILE): one contiguous block per cluster."""
    c = tri_weights.shape[2] // TRI_TILE
    return (tri_weights.reshape(16, 4, c, TRI_TILE).permute(2, 0, 1, 3)
            .reshape(c, 16, 4 * TRI_TILE).contiguous())


def cluster_bounds(mesh):
    """(C, 3) lower and upper corners of each TRI_TILE-triangle cluster's
    box; the padding replicates the last triangle."""
    v0 = mesh.v0
    v1 = v0 + mesh.e1
    v2 = v0 + mesh.e2
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    t = v0.shape[0]
    pad = -(-t // TRI_TILE) * TRI_TILE - t
    if pad:
        lo = torch.cat([lo, lo[-1:].expand(pad, 3)])
        hi = torch.cat([hi, hi[-1:].expand(pad, 3)])
    # scale-relative pad: the f32 slab test in tile_cluster_mask rounds in
    # proportion to the coordinates, so an absolute pad would under-cover
    # large scenes and cull a grazing tile wrongly
    eps = 1e-5 * torch.maximum(
        torch.ones((), dtype=lo.dtype, device=lo.device),
        torch.maximum(lo.abs().max(), hi.abs().max()))
    c_lo = lo.reshape(-1, TRI_TILE, 3).amin(dim=1) - eps
    c_hi = hi.reshape(-1, TRI_TILE, 3).amax(dim=1) + eps
    return c_lo, c_hi


def ray_features(origins: torch.Tensor, directions: torch.Tensor):
    """(N, 16) f32 ray features ``[d, o x d, o, 1, 0 x 6]``."""
    n = origins.shape[0]
    one = torch.ones((n, 1), dtype=origins.dtype, device=origins.device)
    zero = torch.zeros((n, 6), dtype=origins.dtype, device=origins.device)
    return torch.cat([directions, lm.cross(origins, directions), origins,
                      one, zero], dim=-1)


def tile_cluster_mask(origins, directions, tminmax, c_lo, c_hi):
    """(n_ray_tiles, C) bool: does any ray of the tile enter the cluster's
    box within its [t_min, t_max]?  A conservative slab test, built over
    pieces of rays so its (rays, C, 3) temporaries stay bounded."""
    n = origins.shape[0]
    step = max(RAY_TILE,
               _MASK_ELEMS // (3 * c_lo.shape[0]) // RAY_TILE * RAY_TILE)
    tiny = torch.full_like(directions, 1e-20)
    inv_d = 1.0 / torch.where(directions.abs() < 1e-20,
                              torch.where(directions < 0, -tiny, tiny),
                              directions)
    out = []
    for s in range(0, n, step):
        o, inv, tm = origins[s:s + step], inv_d[s:s + step], tminmax[s:s + step]
        t1 = (c_lo[None] - o[:, None]) * inv[:, None]
        t2 = (c_hi[None] - o[:, None]) * inv[:, None]
        tn = torch.minimum(t1, t2).amax(dim=-1)
        tf = torch.maximum(t1, t2).amin(dim=-1)
        hit = (tn <= tf) & (tf >= tm[:, 0:1]) & (tn <= tm[:, 1:2])
        out.append(hit.reshape(-1, RAY_TILE, hit.shape[-1]).any(dim=1))
    return torch.cat(out)


def cluster_ids(mask: torch.Tensor):
    """Each tile's admitted cluster ids, ascending, then the rejected ones
    (``(tiles, C)`` int32), and the admitted count (``(tiles,)`` int32)."""
    ids = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    return ids.to(torch.int32), mask.sum(dim=1, dtype=torch.int32)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _cluster_hits(f, tm, w):
    """Hits of rays ``f`` (n, 16) against one cluster's weights ``w``
    (16, 4 * TRI_TILE): ``(t, valid)``, each (n, TRI_TILE).  The dot
    products run element by element in the kernel's order."""
    T = TRI_TILE

    def col(r, b):
        return w[r, b * T:(b + 1) * T][None, :]

    def x(k):
        return f[:, k:k + 1]

    det = (x(0) * col(0, 0) + x(1) * col(1, 0)) + x(2) * col(2, 0)
    un = x(0) * col(0, 1) + x(1) * col(1, 1)
    vn = x(0) * col(0, 2) + x(1) * col(1, 2)
    for k in range(2, 6):
        un = un + x(k) * col(k, 1)
        vn = vn + x(k) * col(k, 2)
    tn = x(6) * col(6, 3) + x(7) * col(7, 3)
    tn = tn + x(8) * col(8, 3)
    tn = tn + x(9) * col(9, 3)
    ok = det.abs() > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    u = un * inv
    v = vn * inv
    t = tn * inv
    valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tm[:, 0:1]) & (t < tm[:, 1:2]))
    return t, valid


def _reference(feats, tminmax, w_c, admitted):
    """Plain nearest hit over the admitted (tile, cluster) pairs: clusters
    ascending, the lowest triangle index on a tie.  Returns (best_t,
    best_tri) as the kernels write them (BIG and -1 for no hit)."""
    n = feats.shape[0]
    dev = feats.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tile = torch.arange(n, device=dev) // RAY_TILE
    for j in range(w_c.shape[0]):
        rays = torch.nonzero(admitted[tile, j]).flatten()
        for s in range(0, rays.shape[0], _PLAIN_CHUNK):
            r = rays[s:s + _PLAIN_CHUNK]
            t, valid = _cluster_hits(feats[r], tminmax[r], w_c[j])
            t = torch.where(valid, t, BIG)
            k = torch.argmin(t, dim=1)
            tk = torch.gather(t, 1, k[:, None])[:, 0]
            take = tk < best_t[r]
            best_t[r] = torch.where(take, tk, best_t[r])
            best_tri[r] = torch.where(take, (j * TRI_TILE + k).to(torch.int32),
                                      best_tri[r])
    return best_t, best_tri


def intersect_dense_reference(feats, tminmax, w_c, mask):
    """Plain version of K3: ``mask`` (tiles, C) bool."""
    return _reference(feats, tminmax, w_c, mask)


def intersect_gather_reference(feats, tminmax, w_c, ids, cnt):
    """Plain version of K4: each tile's first ``cnt`` entries of ``ids``."""
    tiles, c = ids.shape
    admitted = torch.zeros((tiles, c), dtype=torch.bool, device=ids.device)
    take = torch.arange(c, device=ids.device)[None, :] < cnt[:, None]
    admitted[torch.nonzero(take, as_tuple=True)[0], ids[take].long()] = True
    return _reference(feats, tminmax, w_c, admitted)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check(t: torch.Tensor, dtype, shape, name: str, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name, feats, tminmax, w_c, lists, any_hit):
    """Check the operands and launch ``name``'s kernel; returns (best_t,
    best_tri)."""
    from light_transport_tpu_torch.ops._build import load_intersect_kernel

    dev = feats.device
    n = feats.shape[0]
    if n % RAY_TILE:
        raise ValueError(f"{name}: {n} rays is not a multiple of {RAY_TILE}")
    tiles, c = n // RAY_TILE, w_c.shape[0]
    _check(feats, torch.float32, (n, 16), "feats", dev)
    _check(tminmax, torch.float32, (n, 2), "tminmax", dev)
    _check(w_c, torch.float32, (c, 16, 4 * TRI_TILE), "weights", dev)
    _check(lists[0], torch.int32, (tiles, c), "mask/ids", dev)
    if len(lists) > 1:
        _check(lists[1], torch.int32, (tiles,), "cnt", dev)
    best_t = torch.empty((n,), dtype=torch.float32, device=dev)
    best_tri = torch.empty((n,), dtype=torch.int32, device=dev)
    if tiles == 0:
        return best_t, best_tri
    lib = load_intersect_kernel()
    vp = ctypes.c_void_p
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, f"{name}_launch")(
        vp(feats.data_ptr()), vp(tminmax.data_ptr()), vp(w_c.data_ptr()),
        *(vp(x.data_ptr()) for x in lists), tiles, c, int(any_hit),
        vp(best_t.data_ptr()), vp(best_tri.data_ptr()), vp(stream))
    if rc != 0:
        raise RuntimeError(f"{name}_launch failed: CUDA error {rc} "
                           f"({lib.intersect_kernel_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    return best_t, best_tri


def _device_type(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def intersect_dense(feats, tminmax, w_c, mask, any_hit=False):
    """K3: on the card the dense kernel, for CPU tensors
    :func:`intersect_dense_reference`.  ``mask`` (tiles, C) bool.  Returns
    (best_t, best_tri) per padded ray."""
    if _device_type(feats, "intersect_dense") == "cuda":
        return _launch("intersect_dense", feats, tminmax, w_c,
                       (mask.to(torch.int32),), any_hit)
    return intersect_dense_reference(feats, tminmax, w_c, mask)


def intersect_gather(feats, tminmax, w_c, ids, cnt, any_hit=False):
    """K4: on the card the gather kernel, for CPU tensors
    :func:`intersect_gather_reference`."""
    if _device_type(feats, "intersect_gather") == "cuda":
        return _launch("intersect_gather", feats, tminmax, w_c, (ids, cnt),
                       any_hit)
    return intersect_gather_reference(feats, tminmax, w_c, ids, cnt)


def intersect_rays_pallas(origins: torch.Tensor, directions: torch.Tensor,
                          mesh, tri_weights=None, t_min=1e-5,
                          t_max=float("inf"), any_hit: bool = False,
                          max_dist=None, clusters=None):
    """Nearest hit (a :class:`Hit`) or, with ``any_hit``, a bool
    occlusion mask against ``max_dist``; the counterpart of JAX's
    function of the same name.  ``tri_weights`` and ``clusters`` default
    to :func:`pack_tri_weights` and :func:`cluster_bounds` of ``mesh``."""
    if tri_weights is None:
        tri_weights = pack_tri_weights(mesh)
    c_lo, c_hi = cluster_bounds(mesh) if clusters is None else clusters
    n = origins.shape[0]
    dev, dt = origins.device, origins.dtype
    n_pad = -(-n // RAY_TILE) * RAY_TILE
    t_hi = max_dist if (any_hit and max_dist is not None) else t_max
    tminmax = torch.stack(
        [torch.as_tensor(t_min, dtype=dt, device=dev).expand(n),
         torch.as_tensor(t_hi, dtype=dt, device=dev).expand(n)], dim=-1)
    feats = ray_features(origins, directions)
    if n_pad != n:
        feats = torch.cat([feats, feats.new_zeros((n_pad - n, 16))])
        tminmax = torch.cat([tminmax, tminmax.new_zeros((n_pad - n, 2))])
    mask = tile_cluster_mask(feats[:, 6:9], feats[:, 0:3], tminmax, c_lo,
                             c_hi)
    w_c = cluster_weights(tri_weights)
    if w_c.shape[0] >= GATHER_MIN_CLUSTERS:
        ids, cnt = cluster_ids(mask)
        best_t, best_tri = intersect_gather(feats, tminmax, w_c, ids, cnt,
                                            any_hit)
    else:
        best_t, best_tri = intersect_dense(feats, tminmax, w_c, mask, any_hit)
    best_t, best_tri = best_t[:n], best_tri[:n]
    if any_hit:
        return best_tri >= 0
    valid = (best_tri >= 0) & (best_t < BIG)
    return Hit(t=torch.where(valid, best_t, float("inf")),
               tri=torch.where(valid, best_tri, -1), valid=valid)
