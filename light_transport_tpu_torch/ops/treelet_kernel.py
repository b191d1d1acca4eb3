"""Treelet BVH traversal for big meshes: the CUDA kernels K5 and K5r, their
plain PyTorch version and the three drivers.

The counterpart of ``light_transport_tpu.ops.pallas.treelet_kernel``.  The
flat roped BVH (``accel.bvh``) is cut into treelets, contiguous
depth-first ranges of ``T`` nodes.  A ray's cursor only moves forward in
depth-first order, so it passes through each treelet at most once, in
ascending order; the wavefront driver re-sorts lanes by cursor between
bounded launches so that neighbouring lanes walk the same treelet.

* **Tables.** :class:`TreeletTables` is the kernels' operand: the BVH's
  own float32 node and leaf records (the same tensors, not copied) and the
  treelet size ``T``.  The TPU kernel padded the records to whole treelets
  and split every value into three bf16 chunks so that its one-hot matmul
  could gather them exactly; Hopper gathers per lane, a lane stops at
  cursor >= M and ``T`` only numbers the treelets, so neither the chunks
  nor the padding are needed.  :func:`build_treelet_tables` keeps JAX's
  limits and errors (node count and ``first + k`` below 2^24,
  ``max_leaf`` at most 4), so both packages accept the same scenes.
* **Kernels** (``csrc/treelet_kernel.cu``, one template): K5
  (``treelet_walk``) walks every lane from the root in one launch; K5r
  (``treelet_resume``) resumes every lane from its cursor, ``best_t`` and
  ``best_tri`` and, with ``max_loads > 0``, stops a lane when it would
  enter treelet number ``max_loads + 1`` of the launch.  One thread per
  ray.  The plain version of both is ``accel.bvh.roped_walk``; they do the
  same arithmetic in the same order, so they agree bitwise.
* **Drivers.** :func:`intersect_bvh_treelet` (one K5 launch),
  :func:`intersect_bvh_treelet_wavefront` (``max_passes`` sorted K5r passes
  of ``loads_per_pass`` treelets, then one unbounded K5r pass) and
  :func:`intersect_bvh_treelet_queued` (sorted passes with a host check
  every ``passes_per_sync``).  A schedule changes no result: each lane's
  walk depends only on its ray and the BVH, so every driver equals the
  roped walk bitwise, ``visits`` (node visits per ray) included.  JAX's
  ``loads`` statistic counts treelet residencies of a TPU ray tile, which
  moves in lockstep; on the card lanes move alone, so it has no
  counterpart here.

``treelet_walk`` and ``treelet_resume`` launch their kernel for CUDA
tensors and run the plain version for CPU tensors; they have no other
path.  ``LAUNCHES`` counts the kernel launches of each.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from light_transport_tpu_torch.accel import bvh as bvh_mod
from light_transport_tpu_torch.ops.intersect import T_EPS, Hit

DEFAULT_T = 512  # nodes per treelet
DEFAULT_R = 256  # rays per padding tile
MAX_LEAF = 4  # the largest leaf the tables (and JAX's bf16 slabs) hold
_INT_LIMIT = 1 << 24  # JAX's 8-bit-digit int split holds values below this
_DONE = torch.iinfo(torch.int32).max  # sort key of a finished lane

# kernel launches made through treelet_walk / treelet_resume (read and
# reset by callers)
LAUNCHES = {"treelet_walk": 0, "treelet_resume": 0}


@dataclasses.dataclass
class TreeletTables:
    """A BVH's fused records cut into treelets of ``T`` nodes: ``node``
    (M, 16) and ``leaf`` (M, W) float32, ``W = accel.bvh.leaf_width(
    max_leaf)``, the BVH's own tensors."""

    node: torch.Tensor
    leaf: torch.Tensor
    T: int = DEFAULT_T
    num_nodes: int = 0
    max_leaf: int = 4

    @staticmethod
    def of(bvh, T: int = DEFAULT_T) -> "TreeletTables":
        """The kernels' view of ``bvh`` (``accel.bvh.BVH``), unchecked."""
        return TreeletTables(node=bvh.node_rec, leaf=bvh.leaf_rec, T=T,
                             num_nodes=bvh.num_nodes, max_leaf=bvh.max_leaf)

    @property
    def n_treelets(self) -> int:
        return -(-self.num_nodes // self.T)

    @property
    def nbytes(self) -> int:
        return (self.node.numel() * self.node.element_size()
                + self.leaf.numel() * self.leaf.element_size())


def build_treelet_tables(bvh, T: int = DEFAULT_T) -> TreeletTables:
    """Treelet tables over a built BVH (``accel.bvh.BVH``), within the
    limits of JAX's table format."""
    m = bvh.num_nodes
    if m >= _INT_LIMIT:
        raise ValueError(f"treelet tables need node count < 2^24, got {m}")
    ints = bvh.node_rec[:, 6:9].view(torch.int32)
    max_prim = int((ints[:, 0] + ints[:, 1]).max())
    if max_prim > _INT_LIMIT:
        raise ValueError(
            f"treelet tables need leaf prim indices < 2^24, got {max_prim} "
            "(mesh too large for the table format)")
    if bvh.max_leaf > MAX_LEAF:
        raise ValueError(f"max_leaf {bvh.max_leaf} > {MAX_LEAF} overflows "
                         "the leaf table")
    return TreeletTables.of(bvh, T)


def _make_feats(origins, directions, t_min, t_max, R):
    """(16, n_pad) per-ray feature rows ``[o, d, 1/d, t_min, t_max, 0 x
    5]``, padded to a multiple of ``R`` with dead lanes (empty ray
    interval); JAX's layout and inverse-direction clamp."""
    n = origins.shape[0]
    n_pad = -(-n // R) * R
    kw = dict(dtype=torch.float32, device=origins.device)
    feats = torch.zeros((16, n_pad), **kw)
    feats[0:3, :n] = origins.T
    feats[3:6, :n] = directions.T
    feats[6:9, :n] = bvh_mod.inverse_directions(directions).T
    feats[9, :n] = torch.as_tensor(t_min, **kw).expand(n)
    feats[10, :n] = torch.as_tensor(t_max, **kw).expand(n)
    if n_pad != n:
        # pad lanes: direction (0, 0, 1) with its clamped inverse (1e20,
        # 1e20, 1), and t_max = -inf, so the lane dies at the root
        feats[5, n:] = 1.0
        feats[6:8, n:] = 1e20
        feats[8, n:] = 1.0
        feats[10, n:] = float("-inf")
    return feats, n_pad


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def treelet_resume_reference(feats, tables: TreeletTables, cursor, best_t,
                             best_tri, max_loads: int, any_hit=False):
    """Plain version of K5r: ``(cursor, best_t, best_tri, visits)``."""
    return bvh_mod.roped_walk(
        tables.node, tables.leaf, tables.num_nodes, tables.max_leaf,
        feats[0:3].T, feats[3:6].T, feats[6:9].T, feats[9], cursor, best_t,
        best_tri, any_hit=any_hit, T=tables.T, max_loads=max_loads)


def treelet_walk_reference(feats, tables: TreeletTables, any_hit=False):
    """Plain version of K5: ``(best_t, best_tri, visits)`` of the walk
    from the root."""
    n = feats.shape[1]
    cursor = torch.zeros((n,), dtype=torch.int32, device=feats.device)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=feats.device)
    _, best_t, best_tri, visits = treelet_resume_reference(
        feats, tables, cursor, feats[10].clone(), best_tri, 0, any_hit)
    return best_t, best_tri, visits


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


def _launch(name, feats, tables, state, max_loads, any_hit, counts):
    """Check the operands and launch ``name``'s kernel.  ``state`` is
    (cursor, best_t, best_tri) for K5r, None for K5; ``counts`` an int64
    (3,) tensor that the kernel adds its node visits, leaf visits and
    triangle tests to, or None.  Returns (cursor, best_t, best_tri,
    visits), the cursor None for K5."""
    from light_transport_tpu_torch.ops._build import load_treelet_kernel

    dev = feats.device
    n = feats.shape[1]
    m = tables.num_nodes
    _check(feats, torch.float32, (16, n), "feats", dev)
    _check(tables.node, torch.float32, (m, 16), "node table", dev)
    _check(tables.leaf, torch.float32,
           (m, bvh_mod.leaf_width(tables.max_leaf)), "leaf table", dev)
    if not 1 <= tables.max_leaf <= MAX_LEAF:
        raise ValueError(f"max_leaf {tables.max_leaf} outside 1..{MAX_LEAF}")
    if tables.node.data_ptr() % 16:
        raise ValueError("node table: the kernel reads float4, so it must "
                         "start on a 16-byte boundary")
    if state is not None:
        _check(state[0], torch.int32, (n,), "cursor", dev)
        _check(state[1], torch.float32, (n,), "best_t", dev)
        _check(state[2], torch.int32, (n,), "best_tri", dev)
    if counts is None:
        counts = torch.zeros((3,), dtype=torch.int64, device=dev)
    _check(counts, torch.int64, (3,), "counts", dev)
    cursor = torch.empty((n,), dtype=torch.int32, device=dev)
    best_t = torch.empty((n,), dtype=torch.float32, device=dev)
    best_tri = torch.empty((n,), dtype=torch.int32, device=dev)
    visits = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        lib = load_treelet_kernel()
        vp = ctypes.c_void_p
        ins = (state if state is not None else (None, None, None))
        rc = lib.treelet_walk_launch(
            vp(feats.data_ptr()), n, vp(tables.node.data_ptr()),
            vp(tables.leaf.data_ptr()), tables.leaf.shape[1],
            tables.max_leaf, tables.num_nodes, tables.T, max_loads,
            int(any_hit), int(state is not None),
            *(vp(None if x is None else x.data_ptr()) for x in ins),
            vp(cursor.data_ptr()), vp(best_t.data_ptr()),
            vp(best_tri.data_ptr()), vp(visits.data_ptr()),
            vp(counts.data_ptr()),
            vp(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(
                f"{name}_launch failed: CUDA error {rc} "
                f"({lib.treelet_kernel_error_string(rc).decode()})")
        LAUNCHES[name] += 1
    return (cursor if state is not None else None), best_t, best_tri, visits


def _device_type(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def treelet_walk(feats, tables: TreeletTables, any_hit=False, counts=None):
    """K5: every lane walked from the root in one launch; for CPU tensors
    :func:`treelet_walk_reference`.  Returns (best_t, best_tri, visits)
    per padded ray (``best_tri`` -1: no hit)."""
    if _device_type(feats, "treelet_walk") == "cuda":
        return _launch("treelet_walk", feats, tables, None, 0, any_hit,
                       counts)[1:]
    return treelet_walk_reference(feats, tables, any_hit)


def treelet_resume(feats, tables: TreeletTables, cursor, best_t, best_tri,
                   max_loads: int, any_hit=False, counts=None):
    """K5r: every lane resumed from its cursor, bounded to ``max_loads``
    treelets (0: no bound); for CPU tensors
    :func:`treelet_resume_reference`.  Returns (cursor, best_t, best_tri,
    visits of this launch)."""
    if max_loads < 0:
        raise ValueError(f"max_loads {max_loads} < 0")
    if _device_type(feats, "treelet_resume") == "cuda":
        return _launch("treelet_resume", feats, tables,
                       (cursor, best_t, best_tri), max_loads, any_hit, counts)
    return treelet_resume_reference(feats, tables, cursor, best_t, best_tri,
                                    max_loads, any_hit)


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def _result(best_t, best_tri, visits, n, any_hit, with_stats, passes):
    best_t, best_tri = best_t[:n], best_tri[:n]
    valid = best_tri >= 0
    hit = valid if any_hit else Hit(
        t=torch.where(valid, best_t, float("inf")), tri=best_tri,
        valid=valid)
    if with_stats:
        return hit, {"visits": visits[:n], "passes": passes}
    return hit


def intersect_bvh_treelet(origins, directions, tables: TreeletTables,
                          t_min=T_EPS, t_max=float("inf"),
                          any_hit: bool = False, ray_tile: int = DEFAULT_R,
                          with_stats: bool = False):
    """Nearest hit (a :class:`Hit`) or any-hit mask by one K5 launch.
    Bitwise equal to ``accel.bvh.intersect_bvh`` on the same BVH; lanes
    whose ``t_max`` is -inf are dead and report no hit."""
    n = origins.shape[0]
    feats, _ = _make_feats(origins, directions, t_min, t_max, ray_tile)
    best_t, best_tri, visits = treelet_walk(feats, tables, any_hit)
    return _result(best_t, best_tri, visits, n, any_hit, with_stats, 1)


def occluded_bvh_treelet(origins, directions, tables: TreeletTables,
                         max_dist, t_min=T_EPS, ray_tile: int = DEFAULT_R):
    return intersect_bvh_treelet(origins, directions, tables, t_min=t_min,
                                 t_max=max_dist, any_hit=True,
                                 ray_tile=ray_tile)


class _Wave(NamedTuple):
    """Wavefront state, lanes in their current (sorted) order."""

    feats: torch.Tensor  # (16, n_pad)
    best_t: torch.Tensor
    cursor: torch.Tensor
    best_tri: torch.Tensor
    orig: torch.Tensor  # each lane's index in the input order
    visits: torch.Tensor


def _wave_init(feats) -> _Wave:
    n_pad = feats.shape[1]
    kw = dict(dtype=torch.int32, device=feats.device)
    return _Wave(feats, feats[10].clone(), torch.zeros((n_pad,), **kw),
                 torch.full((n_pad,), -1, **kw),
                 torch.arange(n_pad, device=feats.device),
                 torch.zeros((n_pad,), **kw))


def _wave_pass(w: _Wave, tables: TreeletTables, max_loads: int,
               any_hit: bool) -> _Wave:
    """One pass: sort the lanes by cursor (finished lanes last, ties in
    order), then one K5r launch bounded to ``max_loads`` treelets."""
    key = torch.where(w.cursor < tables.num_nodes, w.cursor, _DONE)
    perm = torch.argsort(key, stable=True)
    feats = w.feats[:, perm].contiguous()
    cursor, best_t, best_tri, visits = treelet_resume(
        feats, tables, w.cursor[perm], w.best_t[perm], w.best_tri[perm],
        max_loads, any_hit)
    return _Wave(feats, best_t, cursor, best_tri, w.orig[perm],
                 w.visits[perm] + visits)


def _wave_live(w: _Wave, tables: TreeletTables) -> bool:
    return bool((w.cursor < tables.num_nodes).any())


def _wave_result(w: _Wave, n, any_hit, with_stats, passes):
    inv = torch.empty_like(w.orig)
    inv[w.orig] = torch.arange(w.orig.shape[0], device=w.orig.device)
    return _result(w.best_t[inv], w.best_tri[inv], w.visits[inv], n,
                   any_hit, with_stats, passes)


def intersect_bvh_treelet_wavefront(
        origins, directions, tables: TreeletTables, t_min=T_EPS,
        t_max=float("inf"), any_hit: bool = False,
        ray_tile: int = DEFAULT_R, with_stats: bool = False,
        loads_per_pass: int = 1, max_passes: int = 12):
    """Up to ``max_passes`` sorted passes of ``loads_per_pass`` treelets
    (while any lane is unfinished), then one unbounded pass that walks the
    stragglers to the end, so ``max_passes`` changes the time, never the
    result.  Bitwise equal to the roped walk and the other drivers."""
    n = origins.shape[0]
    feats, _ = _make_feats(origins, directions, t_min, t_max, ray_tile)
    w = _wave_init(feats)
    passes = 0
    for _ in range(max_passes):
        if not _wave_live(w, tables):
            break
        w = _wave_pass(w, tables, loads_per_pass, any_hit)
        passes += 1
    w = _wave_pass(w, tables, 0, any_hit)
    return _wave_result(w, n, any_hit, with_stats, passes + 1)


def intersect_bvh_treelet_queued(
        origins, directions, tables: TreeletTables, t_min=T_EPS,
        t_max=float("inf"), any_hit: bool = False,
        ray_tile: int = DEFAULT_R, with_stats: bool = False,
        loads_per_pass: int = 4, passes_per_sync: int = 8,
        max_sync_rounds: int = 4096):
    """Sorted passes of ``loads_per_pass`` treelets, ``passes_per_sync``
    of them between host checks, until every lane has finished.  Same
    contract as :func:`intersect_bvh_treelet`."""
    if loads_per_pass < 1:
        raise ValueError(f"loads_per_pass {loads_per_pass} < 1")
    n = origins.shape[0]
    feats, _ = _make_feats(origins, directions, t_min, t_max, ray_tile)
    w = _wave_init(feats)
    passes = 0
    for _ in range(max_sync_rounds):
        for _ in range(passes_per_sync):
            w = _wave_pass(w, tables, loads_per_pass, any_hit)
        passes += passes_per_sync
        if not _wave_live(w, tables):
            break
    else:
        raise RuntimeError(f"treelet wavefront did not converge in "
                           f"{max_sync_rounds * passes_per_sync} passes")
    return _wave_result(w, n, any_hit, with_stats, passes)
