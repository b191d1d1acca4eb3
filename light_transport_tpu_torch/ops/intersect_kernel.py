"""Cluster-culled brute-force intersection: the CUDA kernels K3, K4 and the
cull that feeds K4, and their plain PyTorch versions.

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
* Both kernels read the triangle-major records of :func:`cluster_records`
  and merge their blocks through 64-bit keys (:func:`hit_keys`).  Meshes
  of fewer than 16 clusters go through the dense kernel (K3,
  ``intersect_dense_keys``): one launch over (ray tile, 128-triangle
  piece) blocks, each block running the cull for its tile and cluster
  first.  Larger meshes go through the cull kernel (``tile_cull``: each
  tile's admitted cluster ids and their count) and the gather kernel
  (K4, ``intersect_gather``) over (tile, chunk of admitted clusters)
  blocks.  K4 also tests each ray against the boxes of the clusters'
  32-triangle groups (:func:`cluster_group_bounds`), and a warp skips a
  group that none of its rays enters: it only skips work, so its hits
  are the plain version's.  The TPU kernel capped the id list and
  chunked the rays for its 1 MB scalar memory; the lists here live in
  device memory, uncapped.
* Each ray keeps the nearest hit; at equal t the lowest triangle index
  wins (the TPU kernel broke exact ties by the lowest ``tri mod 128``).

``intersect_dense_keys``, ``tile_cull`` and ``intersect_gather`` launch
their kernel for CUDA tensors and run the plain version for CPU tensors;
they have no other path.  ``LAUNCHES`` counts the kernel launches of each
(K3's as ``intersect_dense``).  ``intersect_dense`` keeps K3's function
on JAX's operands (the (C, 16, 2048) weights and a given mask) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.ops.intersect import DET_EPS, Hit
from light_transport_tpu_torch.utils import profiling

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
# (feature row, weight block) of the 19 non-zero weight rows, in the order
# the kernels read them: det rows 0-2, u rows 0-5, v rows 0-5, t rows 6-9
STAGED_ROWS = (tuple((r, 0) for r in range(3))
               + tuple((r, 1) for r in range(6))
               + tuple((r, 2) for r in range(6))
               + tuple((r, 3) for r in range(6, 10)))
REC_FLOATS = 20  # a triangle's record: the 19 rows and a pad (80 B)
# admitted clusters per K4 block: a tile's list is cut into chunks of this
# many, one block each (4 ran fastest of 1-32 and one block per tile on
# the soft-shadow render's heaviest launches on an H100: chip_smoke.py
# phase 10's sweep)
GATHER_CHUNK = 4
PIECE_TRIS = 128  # triangles of a K3 piece (10,240 B of records)
PIECES = TRI_TILE // PIECE_TRIS
# triangles of a K4 group: a warp tests a group's records only if one of
# its 32 rays enters the group's box
GROUP_TRIS = 32
GROUPS = TRI_TILE // GROUP_TRIS
WARP = 32  # rays of a warp
# 128-triangle pieces per K3 block (1, 2 or 4: a block stays in one
# cluster).  1 ran fastest of the three on the glass render's and the
# 15-cluster batches' heaviest launches on an H100: chip_smoke.py phase 9's
# sweep
DENSE_PIECES = 1
# the key of "no hit": above every hit's key (int64 max)
NO_HIT_KEY = (1 << 63) - 1

# kernel launches made through intersect_dense / tile_cull /
# intersect_gather (read and reset by callers)
LAUNCHES = {"intersect_dense": 0, "tile_cull": 0, "intersect_gather": 0}


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


def cluster_records(tri_weights: torch.Tensor) -> torch.Tensor:
    """(C, TRI_TILE, REC_FLOATS) f32 triangle-major records: triangle k of
    cluster c holds its 19 non-zero weights in :data:`STAGED_ROWS` order
    and a zero pad, so a cluster is one contiguous 40,960 B record.  K4's
    layout, built once per scene."""
    c = tri_weights.shape[2] // TRI_TILE
    rows = torch.stack([tri_weights[r, b] for r, b in STAGED_ROWS], dim=-1)
    rec = torch.zeros((c * TRI_TILE, REC_FLOATS), dtype=torch.float32,
                      device=tri_weights.device)
    rec[:, :len(STAGED_ROWS)] = rows
    return rec.reshape(c, TRI_TILE, REC_FLOATS)


def _triangle_boxes(mesh):
    """(T_pad, 3) lower and upper corners of each triangle, the padding
    replicating the last triangle, and the boxes' scale-relative pad."""
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
    return lo, hi, eps


def cluster_bounds(mesh):
    """(C, 3) lower and upper corners of each TRI_TILE-triangle cluster's
    box; the padding replicates the last triangle."""
    lo, hi, eps = _triangle_boxes(mesh)
    c_lo = lo.reshape(-1, TRI_TILE, 3).amin(dim=1) - eps
    c_hi = hi.reshape(-1, TRI_TILE, 3).amax(dim=1) + eps
    return c_lo, c_hi


def cluster_group_bounds(mesh):
    """(C, GROUPS, 3) lower and upper corners of each run of GROUP_TRIS
    consecutive triangles (K4's groups), with :func:`cluster_bounds`'
    padding and pad: a cluster's groups together span its box exactly."""
    lo, hi, eps = _triangle_boxes(mesh)
    g_lo = lo.reshape(-1, GROUPS, GROUP_TRIS, 3).amin(dim=2) - eps
    g_hi = hi.reshape(-1, GROUPS, GROUP_TRIS, 3).amax(dim=2) + eps
    return g_lo.contiguous(), g_hi.contiguous()


class ClusterTables(NamedTuple):
    """A mesh's tables for the cluster intersector, each field named as
    the keyword of :func:`intersect_rays_pallas` that takes it."""

    tri_weights: torch.Tensor  # pack_tri_weights
    clusters: Tuple[torch.Tensor, torch.Tensor]  # cluster_bounds
    records: torch.Tensor  # cluster_records (K3 and K4 read them)
    groups: Tuple[torch.Tensor, torch.Tensor]  # cluster_group_bounds (K4)


def cluster_tables(mesh) -> ClusterTables:
    """The mesh's :class:`ClusterTables`, built on the first call and kept
    in ``mesh.derived``."""
    if "cluster" not in mesh.derived:
        w = pack_tri_weights(mesh)
        mesh.derived["cluster"] = ClusterTables(
            w, cluster_bounds(mesh), cluster_records(w),
            cluster_group_bounds(mesh))
    return mesh.derived["cluster"]


def ray_features(origins: torch.Tensor, directions: torch.Tensor):
    """(N, 16) f32 ray features ``[d, o x d, o, 1, 0 x 6]``."""
    n = origins.shape[0]
    one = torch.ones((n, 1), dtype=origins.dtype, device=origins.device)
    zero = torch.zeros((n, 6), dtype=origins.dtype, device=origins.device)
    return torch.cat([directions, lm.cross(origins, directions), origins,
                      one, zero], dim=-1)


def tile_cluster_mask(origins, directions, tminmax, c_lo, c_hi,
                      rays=RAY_TILE):
    """(n_ray_tiles, C) bool: does any ray of the tile (``rays`` rays)
    enter the cluster's box within its [t_min, t_max]?  A conservative
    slab test, built over pieces of rays so its (rays, C, 3) temporaries
    stay bounded."""
    n = origins.shape[0]
    step = max(rays, _MASK_ELEMS // (3 * c_lo.shape[0]) // rays * rays)
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
        out.append(hit.reshape(-1, rays, hit.shape[-1]).any(dim=1))
    return torch.cat(out)


def cluster_ids(mask: torch.Tensor):
    """Each tile's admitted cluster ids, ascending, then the rejected ones
    (``(tiles, C)`` int32), and the admitted count (``(tiles,)`` int32)."""
    ids = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    return ids.to(torch.int32), mask.sum(dim=1, dtype=torch.int32)


def hit_keys(t: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """int64 keys that order as (t, tri): the order-preserving bits of t
    (-0 read as +0) above the triangle index.  K4 merges its blocks by the
    minimum key; only hits with t < BIG and tri >= 0 get one."""
    b = torch.where(t == 0.0, 0.0, t).view(torch.int32)
    s = torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)
    return (s << 32) | tri.to(torch.int64)


def unpack_hit_keys(keys: torch.Tensor):
    """(best_t, best_tri) of int64 keys; :data:`NO_HIT_KEY` gives BIG and
    -1, as the sequential scan leaves a ray without a hit."""
    s = (keys >> 32).to(torch.int32)
    t = torch.where(s < 0, s ^ 0x7FFFFFFF, s).view(torch.float32)
    none = keys == NO_HIT_KEY
    return (torch.where(none, BIG, t),
            torch.where(none, -1, (keys & 0xFFFFFFFF).to(torch.int32)))


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _cluster_hits(f, tm, rows):
    """Hits of rays ``f`` (n, 16) against one cluster's 19 weight rows
    ``rows`` (19, TRI_TILE, in :data:`STAGED_ROWS` order): ``(t, valid)``,
    each (n, TRI_TILE).  The dot products run element by element in the
    kernels' order."""

    def row(i):
        return rows[i][None, :]

    def x(k):
        return f[:, k:k + 1]

    det = (x(0) * row(0) + x(1) * row(1)) + x(2) * row(2)
    un = x(0) * row(3) + x(1) * row(4)
    vn = x(0) * row(9) + x(1) * row(10)
    for k in range(2, 6):
        un = un + x(k) * row(3 + k)
        vn = vn + x(k) * row(9 + k)
    tn = x(6) * row(15) + x(7) * row(16)
    tn = tn + x(8) * row(17)
    tn = tn + x(9) * row(18)
    ok = det.abs() > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    u = un * inv
    v = vn * inv
    t = tn * inv
    valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tm[:, 0:1]) & (t < tm[:, 1:2]))
    return t, valid


def _weight_rows(w_c):
    """Cluster j's 19 weight rows of the (C, 16, 4 * TRI_TILE) weights."""
    r, b = (torch.tensor(x, device=w_c.device) for x in zip(*STAGED_ROWS))
    return lambda j: w_c[j].reshape(16, 4, TRI_TILE)[r, b]


def _record_rows(recs):
    """Cluster j's 19 weight rows of the (C, TRI_TILE, 20) records."""
    return lambda j: recs[j, :, :len(STAGED_ROWS)].T


def _reference(feats, tminmax, rows_of, admitted):
    """Plain nearest hit over the admitted (tile, cluster) pairs
    (``admitted`` (tiles, C) bool; ``rows_of(j)`` cluster j's weight rows):
    clusters ascending, the lowest triangle index on a tie.  Returns
    (best_t, best_tri) as the kernels write them (BIG and -1 for no
    hit)."""
    n = feats.shape[0]
    dev = feats.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tile = torch.arange(n, device=dev) // RAY_TILE
    for j in range(admitted.shape[1]):
        rays = torch.nonzero(admitted[tile, j]).flatten()
        if rays.shape[0] == 0:
            continue
        rows = rows_of(j)
        for s in range(0, rays.shape[0], _PLAIN_CHUNK):
            r = rays[s:s + _PLAIN_CHUNK]
            t, valid = _cluster_hits(feats[r], tminmax[r], rows)
            t = torch.where(valid, t, BIG)
            k = torch.argmin(t, dim=1)
            tk = torch.gather(t, 1, k[:, None])[:, 0]
            take = tk < best_t[r]
            best_t[r] = torch.where(take, tk, best_t[r])
            best_tri[r] = torch.where(take, (j * TRI_TILE + k).to(torch.int32),
                                      best_tri[r])
    return best_t, best_tri


def intersect_dense_reference(feats, tminmax, w_c, mask):
    """K3's function on JAX's operands, the sequential scan: ``w_c`` the
    (C, 16, 4 * TRI_TILE) weights, ``mask`` (tiles, C) bool."""
    return _reference(feats, tminmax, _weight_rows(w_c), mask)


def intersect_dense_keys_reference(feats, tminmax, recs, c_lo, c_hi):
    """Plain version of K3's launch: the cull
    (:func:`tile_cluster_mask`; min and max round nothing, so the
    kernel's pairwise order admits the same pairs); then, for each
    admitted (tile, cluster)
    pair, each ray with a non-empty interval tests each 128-triangle piece
    (``recs`` the (C, TRI_TILE, 20) records) and keeps the piece's nearest
    hit, the lowest index on a tie; the pieces merge by the minimum
    :func:`hit_keys` key.  Returns each ray's key (:data:`NO_HIT_KEY`
    where it has none); unpacked, it equals the sequential scan
    (:func:`intersect_dense_reference`) bitwise."""
    n, dev = feats.shape[0], feats.device
    admitted = tile_cluster_mask(feats[:, 6:9], feats[:, 0:3], tminmax,
                                 c_lo, c_hi)
    live = tminmax[:, 0] < tminmax[:, 1]
    tile = torch.arange(n, device=dev) // RAY_TILE
    first = torch.arange(PIECES, device=dev) * PIECE_TRIS
    keys = torch.full((n,), NO_HIT_KEY, dtype=torch.int64, device=dev)
    rows_of = _record_rows(recs)
    for j in range(admitted.shape[1]):
        rays = torch.nonzero(admitted[tile, j] & live).flatten()
        for s in range(0, rays.shape[0], _PLAIN_CHUNK):
            r = rays[s:s + _PLAIN_CHUNK]
            t, valid = _cluster_hits(feats[r], tminmax[r], rows_of(j))
            t = torch.where(valid, t, BIG).reshape(-1, PIECES, PIECE_TRIS)
            k = torch.argmin(t, dim=2)  # each piece's first minimum
            tk = torch.gather(t, 2, k[..., None])[..., 0]
            tri = (j * TRI_TILE + first + k).to(torch.int32)
            piece = torch.where(tk < BIG, hit_keys(tk, tri), NO_HIT_KEY)
            keys[r] = torch.minimum(keys[r], piece.amin(dim=1))
    return keys


def tile_cull_reference(feats, tminmax, c_lo, c_hi):
    """Plain version of the cull kernel: :func:`tile_cluster_mask` of the
    features' origins and directions, compacted by :func:`cluster_ids`."""
    return cluster_ids(tile_cluster_mask(feats[:, 6:9], feats[:, 0:3],
                                         tminmax, c_lo, c_hi))


def intersect_gather_reference(feats, tminmax, recs, ids, cnt):
    """Plain version of K4: each tile's first ``cnt`` entries of ``ids``
    (``recs`` the (C, TRI_TILE, 20) records), scanned in order."""
    tiles, width = ids.shape
    admitted = torch.zeros((tiles, recs.shape[0]), dtype=torch.bool,
                           device=ids.device)
    take = torch.arange(width, device=ids.device)[None, :] < cnt[:, None]
    admitted[torch.nonzero(take, as_tuple=True)[0], ids[take].long()] = True
    return _reference(feats, tminmax, _record_rows(recs), admitted)


def intersect_gather_split_reference(feats, tminmax, recs, ids, cnt,
                                     chunk=GATHER_CHUNK):
    """K4's schedule in plain form: each tile's list cut into chunks of
    ``chunk`` clusters, each chunk's nearest hit by
    :func:`intersect_gather_reference`, the chunks merged by the minimum
    :func:`hit_keys` key.  Equals the sequential scan bitwise."""
    keys = torch.full((feats.shape[0],), NO_HIT_KEY, dtype=torch.int64,
                      device=feats.device)
    for first in range(0, ids.shape[1], chunk):
        part = (cnt - first).clamp(0, chunk).to(torch.int32)
        t, tri = intersect_gather_reference(feats, tminmax, recs,
                                            ids[:, first:first + chunk], part)
        keys = torch.where(tri >= 0, torch.minimum(keys, hit_keys(t, tri)),
                           keys)
    return unpack_hit_keys(keys)


def gather_group_count(feats, tminmax, ids, cnt, g_lo, g_hi):
    """The (warp, group) pairs K4 tests in nearest-hit mode, in plain
    form: over each tile's admitted clusters (the first ``cnt`` of
    ``ids``), the 32-triangle groups (``g_lo``, ``g_hi``: (C, GROUPS, 3))
    whose box some ray of a 32-ray warp enters within a non-empty
    interval (:func:`tile_cluster_mask`'s slab test).  Any-hit mode tests
    at most as many (a ray already hit enters nothing).  An int64
    scalar."""
    n, dev = feats.shape[0], feats.device
    c = g_lo.shape[0]
    live = tminmax[:, 0] < tminmax[:, 1]
    tm = torch.where(live[:, None], tminmax, float("nan"))
    enters = tile_cluster_mask(feats[:, 6:9], feats[:, 0:3], tm,
                               g_lo.reshape(-1, 3), g_hi.reshape(-1, 3),
                               rays=WARP)
    admitted = torch.zeros((n // RAY_TILE, c), dtype=torch.bool, device=dev)
    take = torch.arange(ids.shape[1], device=dev)[None, :] < cnt[:, None]
    admitted[torch.nonzero(take, as_tuple=True)[0], ids[take].long()] = True
    per_warp = admitted.repeat_interleave(RAY_TILE // WARP, dim=0)
    return (enters.reshape(-1, c, GROUPS) & per_warp[:, :, None]).sum()


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


def _tiles(name, feats, tminmax):
    """Check the rays' operands; returns the number of ray tiles."""
    n = feats.shape[0]
    if n % RAY_TILE:
        raise ValueError(f"{name}: {n} rays is not a multiple of {RAY_TILE}")
    _check(feats, torch.float32, (n, 16), "feats", feats.device)
    _check(tminmax, torch.float32, (n, 2), "tminmax", feats.device)
    return n // RAY_TILE


def _run(name, dev, *args):
    """Call ``<name>_launch`` on ``dev``'s current stream; raises on a CUDA
    error and counts the launch."""
    from light_transport_tpu_torch.ops._build import load_intersect_kernel

    lib = load_intersect_kernel()
    rc = getattr(lib, f"{name}_launch")(
        *args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        msg = lib.intersect_kernel_error_string(rc).decode()
        raise RuntimeError(f"{name}_launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _device_type(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def intersect_dense(feats, tminmax, w_c, mask, any_hit=False):
    """K3's function on JAX's operands (the (C, 16, 4 * TRI_TILE) weights
    and a given (tiles, C) bool mask), for CPU tensors:
    :func:`intersect_dense_reference`.  Returns (best_t, best_tri) per
    padded ray.  The card's K3 culls inside its launch and reads the
    records: :func:`intersect_dense_keys`."""
    if _device_type(feats, "intersect_dense") != "cpu":
        raise ValueError("intersect_dense takes CPU tensors; on the card "
                         "K3 is intersect_dense_keys")
    return intersect_dense_reference(feats, tminmax, w_c, mask)


def intersect_dense_keys(feats, tminmax, recs, c_lo, c_hi, any_hit=False,
                         pieces=None):
    """K3: on the card one launch of the dense kernel over (ray tile,
    ``pieces`` 128-triangle pieces) blocks (default
    :data:`DENSE_PIECES`), each culling its tile against its cluster's
    box first; for CPU tensors :func:`intersect_dense_keys_reference`.
    ``recs`` the (C, TRI_TILE, 20) records, ``c_lo``/``c_hi`` the (C, 3)
    boxes.  Returns each padded ray's :func:`hit_keys` key
    (:data:`NO_HIT_KEY` where it has none)."""
    if _device_type(feats, "intersect_dense") == "cpu":
        return intersect_dense_keys_reference(feats, tminmax, recs, c_lo,
                                              c_hi)
    dev = feats.device
    tiles, c = _tiles("intersect_dense", feats, tminmax), recs.shape[0]
    _check(recs, torch.float32, (c, TRI_TILE, REC_FLOATS), "records", dev)
    _check(c_lo, torch.float32, (c, 3), "c_lo", dev)
    _check(c_hi, torch.float32, (c, 3), "c_hi", dev)
    if recs.data_ptr() % 16:  # the bulk copies' source
        raise ValueError("records: must start on a 16-byte boundary")
    pieces = DENSE_PIECES if pieces is None else int(pieces)
    if pieces not in (1, 2, 4):
        raise ValueError(f"intersect_dense: pieces {pieces} not 1, 2 or 4")
    keys = torch.full((feats.shape[0],), NO_HIT_KEY, dtype=torch.int64,
                      device=dev)
    if tiles:
        _run("intersect_dense", dev, _ptr(feats), _ptr(tminmax), _ptr(recs),
             _ptr(c_lo), _ptr(c_hi), tiles, c, pieces, int(any_hit),
             _ptr(keys))
    return keys


def tile_cull(feats, tminmax, c_lo, c_hi, counts=None):
    """The cull in front of K4: on the card the cull kernel, for CPU
    tensors :func:`tile_cull_reference`.  Returns each tile's admitted
    cluster ids, ascending (``(tiles, C)`` int32, of which only each
    tile's first ``cnt`` entries are written on the card), and ``cnt``
    (``(tiles,)`` int32).  ``counts``, if given, a ``(2,)`` int64 tensor
    on the rays' device, receives the sum of ``cnt`` and the number of
    rays with ``t_max > t_min`` (added to it: on the card by the cull
    kernel itself)."""
    if _device_type(feats, "tile_cull") == "cpu":
        ids, cnt = tile_cull_reference(feats, tminmax, c_lo, c_hi)
        if counts is not None:
            counts += torch.stack([cnt.sum(dtype=torch.int64),
                                   (tminmax[:, 1] > tminmax[:, 0]).sum()])
        return ids, cnt
    dev = feats.device
    tiles, c = _tiles("tile_cull", feats, tminmax), c_lo.shape[0]
    _check(c_lo, torch.float32, (c, 3), "c_lo", dev)
    _check(c_hi, torch.float32, (c, 3), "c_hi", dev)
    if counts is not None:
        _check(counts, torch.int64, (2,), "counts", dev)
    ids = torch.empty((tiles, c), dtype=torch.int32, device=dev)
    cnt = torch.empty((tiles,), dtype=torch.int32, device=dev)
    if tiles:
        _run("tile_cull", dev, _ptr(feats), _ptr(tminmax), _ptr(c_lo),
             _ptr(c_hi), tiles, c, _ptr(ids), _ptr(cnt),
             ctypes.c_void_p(None if counts is None else counts.data_ptr()))
    return ids, cnt


def intersect_gather_keys(feats, tminmax, recs, ids, cnt, any_hit=False,
                          chunk=None, *, groups, counts=None):
    """K4's launch: each ray's :func:`hit_keys` key (``NO_HIT_KEY`` where
    it has none), from blocks of ``chunk`` admitted clusters (default
    :data:`GATHER_CHUNK`); ``groups`` the (C, GROUPS, 3) group boxes of
    :func:`cluster_group_bounds`.  ``counts``, if given, a ``(1,)``
    int64 tensor on the rays' device, receives the (warp, group) pairs
    the kernel tested (added to it by the kernel).  CUDA tensors only."""
    dev = feats.device
    tiles, c = _tiles("intersect_gather", feats, tminmax), recs.shape[0]
    _check(recs, torch.float32, (c, TRI_TILE, REC_FLOATS), "records", dev)
    g_lo, g_hi = groups
    _check(g_lo, torch.float32, (c, GROUPS, 3), "g_lo", dev)
    _check(g_hi, torch.float32, (c, GROUPS, 3), "g_hi", dev)
    _check(ids, torch.int32, (tiles, c), "ids", dev)
    _check(cnt, torch.int32, (tiles,), "cnt", dev)
    if counts is not None:
        _check(counts, torch.int64, (1,), "counts", dev)
    if recs.data_ptr() % 16:  # the bulk copies' source
        raise ValueError("records: must start on a 16-byte boundary")
    chunk = GATHER_CHUNK if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"intersect_gather: chunk {chunk} < 1")
    keys = torch.full((feats.shape[0],), NO_HIT_KEY, dtype=torch.int64,
                      device=dev)
    if tiles:
        _run("intersect_gather", dev, _ptr(feats), _ptr(tminmax), _ptr(recs),
             _ptr(g_lo), _ptr(g_hi), _ptr(ids), _ptr(cnt), tiles, c, chunk,
             int(any_hit), _ptr(keys),
             ctypes.c_void_p(None if counts is None else counts.data_ptr()))
    return keys


def intersect_gather(feats, tminmax, recs, ids, cnt, any_hit=False, *,
                     groups=None, counts=None):
    """K4: on the card the gather kernel, its keys unpacked; for CPU
    tensors :func:`intersect_gather_reference`.  Returns (best_t,
    best_tri) per padded ray.  ``groups``: the (C, GROUPS, 3) group boxes
    (:func:`cluster_group_bounds`; the card needs them).  ``counts``, if
    given, a ``(1,)`` int64 tensor on the rays' device, receives the
    (warp, group) pairs tested: the kernel's own count on the card,
    :func:`gather_group_count` for CPU tensors."""
    cpu = _device_type(feats, "intersect_gather") == "cpu"
    if groups is None and (counts is not None or not cpu):
        raise ValueError("intersect_gather: K4 and its count need the "
                         "group boxes (cluster_group_bounds)")
    if cpu:
        if counts is not None:
            counts += gather_group_count(feats, tminmax, ids, cnt, *groups)
        return intersect_gather_reference(feats, tminmax, recs, ids, cnt)
    return unpack_hit_keys(intersect_gather_keys(
        feats, tminmax, recs, ids, cnt, any_hit, groups=groups,
        counts=counts))


def _blocks_per_sm(name, *args) -> int:
    from light_transport_tpu_torch.ops._build import load_intersect_kernel

    n = ctypes.c_int(0)
    rc = getattr(load_intersect_kernel(), f"{name}_blocks_per_sm")(
        *args, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return n.value


def gather_blocks_per_sm() -> int:
    """K4's resident blocks per SM at :data:`GATHER_CHUNK` clusters a
    block (CUDA's occupancy calculator)."""
    return _blocks_per_sm("intersect_gather", GATHER_CHUNK)


def dense_blocks_per_sm(pieces=None) -> int:
    """K3's resident blocks per SM at ``pieces`` pieces a block (CUDA's
    occupancy calculator)."""
    return _blocks_per_sm("intersect_dense",
                          DENSE_PIECES if pieces is None else int(pieces))


def intersect_rays_pallas(origins: torch.Tensor, directions: torch.Tensor,
                          mesh, tri_weights=None, t_min=1e-5,
                          t_max=float("inf"), any_hit: bool = False,
                          max_dist=None, clusters=None, records=None,
                          groups=None):
    """Nearest hit (a :class:`Hit`) or, with ``any_hit``, a bool
    occlusion mask against ``max_dist``; the counterpart of JAX's
    function of the same name.  ``tri_weights``, ``clusters``,
    ``records`` and ``groups`` default to :func:`pack_tri_weights`,
    :func:`cluster_bounds`, :func:`cluster_records` and
    :func:`cluster_group_bounds` of ``mesh``, built anew; the dispatch
    passes the mesh's cached :func:`cluster_tables`."""
    if tri_weights is None:
        tri_weights = pack_tri_weights(mesh)
    c_lo, c_hi = cluster_bounds(mesh) if clusters is None else clusters
    n = origins.shape[0]
    dev, dt = origins.device, origins.dtype
    n_pad = -(-n // RAY_TILE) * RAY_TILE
    t_hi = max_dist if (any_hit and max_dist is not None) else t_max
    tminmax = torch.stack(
        [lm.device_const(t_min, dt, dev).expand(n),
         lm.device_const(t_hi, dt, dev).expand(n)], dim=-1)
    feats = ray_features(origins, directions)
    if n_pad != n:
        feats = torch.cat([feats, feats.new_zeros((n_pad - n, 16))])
        tminmax = torch.cat([tminmax, tminmax.new_zeros((n_pad - n, 2))])
    if records is None:
        records = cluster_records(tri_weights)
    if tri_weights.shape[2] // TRI_TILE >= GATHER_MIN_CLUSTERS:
        if groups is None:
            groups = cluster_group_bounds(mesh)
        acc = profiling.cull_counts("any" if any_hit else "nearest", dev)
        ids, cnt = tile_cull(feats, tminmax, c_lo, c_hi,
                             counts=None if acc is None else acc[:2])
        best_t, best_tri = intersect_gather(
            feats, tminmax, records, ids, cnt, any_hit, groups=groups,
            counts=None if acc is None else acc[2:])
        best_t, best_tri = best_t[:n], best_tri[:n]
        if any_hit:
            return best_tri >= 0
        valid = (best_tri >= 0) & (best_t < BIG)
    else:
        keys = intersect_dense_keys(feats, tminmax, records, c_lo, c_hi,
                                    any_hit)[:n]
        valid = keys != NO_HIT_KEY  # a keyed hit has t < BIG
        if any_hit:
            return valid
        best_t, best_tri = unpack_hit_keys(keys)
    return Hit(t=torch.where(valid, best_t, float("inf")),
               tri=torch.where(valid, best_tri, -1), valid=valid)
