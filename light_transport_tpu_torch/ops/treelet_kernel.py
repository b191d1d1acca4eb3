"""Treelet BVH traversal for big meshes: the CUDA kernels K5 and K5r, their
plain PyTorch version and the three drivers.

The counterpart of ``light_transport_tpu.ops.pallas.treelet_kernel``.  The
flat roped BVH (``accel.bvh``) is cut into treelets, contiguous
depth-first ranges of ``T`` nodes.  A ray's cursor only moves forward in
depth-first order, so it passes through each treelet at most once, in
ascending order; the wavefront driver sorts the lanes by cursor between
bounded launches so that the lanes of a block walk the same treelets.

* **Tables.** :class:`TreeletTables` is the kernels' operand: the BVH's
  own float32 node and leaf records (the same tensors, not copied), the
  treelet size ``T``, and the BVH's 32-byte node records that K5 reads
  (``accel.bvh.node_records32``, built with the BVH: half the bytes of
  the 64-byte rows, 84.6 MB on the 4.2M-triangle big mesh).
  The TPU kernel padded the records to whole treelets
  and split every value into three bf16 chunks so that its one-hot matmul
  could gather them exactly; on the card a treelet is ``T`` contiguous
  64-byte rows of the node records, copied as they are into shared memory
  (the last one short), so neither the chunks nor the padding are needed.
  :func:`build_treelet_tables` keeps JAX's limits and errors (node count
  and ``first + k`` below 2^24, ``max_leaf`` at most 4), so both packages
  accept the same scenes.
* **Kernels** (``csrc/treelet_kernel.cu``; one thread per ray): K5
  (``treelet_walk``, its own kernel) walks every lane from the root in one
  launch over the 32-byte records, a leaf's triangles read in 16-byte
  loads all at once; K5r (``treelet_resume``)
  resumes the lanes from their cursor,
  ``best_t`` and ``best_tri`` and, with ``max_loads > 0``, stops a lane
  when it would enter treelet number ``max_loads + 1`` of the launch.
  K5r's thread ``i`` walks lane ``perm[i]`` and updates the :class:`Lanes`
  state in place; in a bounded pass a block stages the treelet of its
  lowest live cursor in shared memory by TMA; a launch can be gated on a
  device word.  The plain version of both is ``accel.bvh.roped_walk``
  (K5's over the 32-byte records, K5r's through ``perm``); they do the
  same arithmetic in the same order, so they agree bitwise.
* **Drivers.** :func:`intersect_bvh_treelet` (one K5 launch),
  :func:`intersect_bvh_treelet_wavefront` (``max_passes`` sorted K5r passes
  of ``loads_per_pass`` treelets, then one unbounded K5r pass, each gated
  on the pass before, with no host read) and
  :func:`intersect_bvh_treelet_queued` (gated passes with a host check
  every ``passes_per_sync``).  A pass sorts only a permutation of the
  lanes; their state stays in place.  A schedule changes no result: each
  lane's walk depends only on its ray and the BVH, so every driver equals
  the roped walk bitwise, ``visits`` (node visits per ray) included.
  JAX's ``loads`` statistic counts treelet residencies of a TPU ray tile,
  which moves in lockstep; on the card lanes move alone, so it has no
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

# kernel launches made through treelet_walk / treelet_resume (read and
# reset by callers)
LAUNCHES = {"treelet_walk": 0, "treelet_resume": 0}


@dataclasses.dataclass
class TreeletTables:
    """A BVH's fused records cut into treelets of ``T`` nodes: ``node``
    (M, 16) and ``leaf`` (M, W) float32, ``W = accel.bvh.leaf_width(
    max_leaf)``, and ``node32`` (M, 8), the same nodes in 32-byte records
    (``accel.bvh.node_records32``): the BVH's own tensors."""

    node: torch.Tensor
    leaf: torch.Tensor
    node32: torch.Tensor
    T: int = DEFAULT_T
    num_nodes: int = 0
    max_leaf: int = 4

    @staticmethod
    def of(bvh, T: int = DEFAULT_T) -> "TreeletTables":
        """The kernels' view of ``bvh`` (``accel.bvh.BVH``), unchecked."""
        return TreeletTables(node=bvh.node_rec, leaf=bvh.leaf_rec,
                             node32=bvh.node32, T=T,
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


def _set_row(row: torch.Tensor, value):
    """``row[:] = value``, a float or a tensor, without a host copy (a
    float fills on the device)."""
    if isinstance(value, torch.Tensor):
        row.copy_(value.to(row.dtype).expand(row.shape[0]))
    else:
        row.fill_(float(value))


def _make_feats(origins, directions, t_min, t_max, R):
    """(16, n_pad) per-ray feature rows ``[o, d, 1/d, t_min, t_max, 0 x
    5]``, padded to a multiple of ``R`` with dead lanes (empty ray
    interval); JAX's layout and inverse-direction clamp."""
    n = origins.shape[0]
    n_pad = -(-n // R) * R
    feats = torch.zeros((16, n_pad), dtype=torch.float32,
                        device=origins.device)
    feats[0:3, :n] = origins.T
    feats[3:6, :n] = directions.T
    feats[6:9, :n] = bvh_mod.inverse_directions(directions).T
    _set_row(feats[9, :n], t_min)
    _set_row(feats[10, :n], t_max)
    if n_pad != n:
        # pad lanes: direction (0, 0, 1) with its clamped inverse (1e20,
        # 1e20, 1), and t_max = -inf, so the lane dies at the root
        feats[5, n:] = 1.0
        feats[6:8, n:] = 1e20
        feats[8, n:] = 1.0
        feats[10, n:] = float("-inf")
    return feats, n_pad


class Lanes(NamedTuple):
    """Per-lane walk state, in the lanes' own order: K5r reads and writes
    it in place at ``perm[i]``."""

    cursor: torch.Tensor  # int32: the next node, >= M once finished
    best_t: torch.Tensor  # float32
    best_tri: torch.Tensor  # int32, -1: no hit yet
    visits: torch.Tensor  # int32: node visits so far

    @staticmethod
    def start(feats) -> "Lanes":
        """Every lane of ``feats`` at the root, with no hit."""
        n = feats.shape[1]
        kw = dict(dtype=torch.int32, device=feats.device)
        return Lanes(torch.zeros((n,), **kw), feats[10].clone(),
                     torch.full((n,), -1, **kw), torch.zeros((n,), **kw))


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def treelet_resume_reference(feats, tables: TreeletTables, perm,
                             lanes: Lanes, max_loads: int, any_hit=False,
                             gate=(None, None)) -> Lanes:
    """Plain version of K5r: the lanes ``perm`` names that are unfinished
    (cursor < M) resume their walk, bounded to ``max_loads`` treelets (0:
    no bound), and ``lanes`` is updated in place (visits added to).  With
    ``gate = (gate_in, gate_out)``: nothing happens when ``gate_in`` holds
    0, and the lanes left unfinished are added to ``gate_out``."""
    gate_in, gate_out = gate
    if gate_in is not None and int(gate_in[0]) == 0:
        return lanes
    idx = perm[lanes.cursor[perm] < tables.num_nodes]
    f = feats[:, idx]
    cursor, best_t, best_tri, visits = bvh_mod.roped_walk(
        tables.node, tables.leaf, tables.num_nodes, tables.max_leaf,
        f[0:3].T, f[3:6].T, f[6:9].T, f[9], lanes.cursor[idx],
        lanes.best_t[idx], lanes.best_tri[idx], any_hit=any_hit, T=tables.T,
        max_loads=max_loads)
    lanes.cursor[idx] = cursor
    lanes.best_t[idx] = best_t
    lanes.best_tri[idx] = best_tri
    lanes.visits[idx] += visits
    if gate_out is not None:
        gate_out += (cursor < tables.num_nodes).sum().to(gate_out.dtype)
    return lanes


def treelet_walk_reference(feats, tables: TreeletTables, any_hit=False):
    """Plain version of K5: ``(best_t, best_tri, visits)`` of the walk
    from the root, reading the 32-byte records as the kernel does."""
    lanes = Lanes.start(feats)
    _, best_t, best_tri, visits = bvh_mod.roped_walk(
        tables.node32, tables.leaf, tables.num_nodes, tables.max_leaf,
        feats[0:3].T, feats[3:6].T, feats[6:9].T, feats[9], lanes.cursor,
        lanes.best_t, lanes.best_tri, any_hit=any_hit, T=tables.T)
    return best_t, best_tri, visits


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

N_COUNTS = 6  # node visits, leaf visits, triangle tests, node visits from
# shared memory and treelets staged (K5r), node visits whose next node is
# the adjacent record, cursor + 1 (K5)


def _check(t: torch.Tensor, dtype, shape, name: str, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _operands(feats, tables, counts):
    """Check what both kernels read; returns the counters (zeros if
    ``counts`` is None)."""
    dev = feats.device
    n = feats.shape[1]
    m = tables.num_nodes
    _check(feats, torch.float32, (16, n), "feats", dev)
    _check(tables.node, torch.float32, (m, 16), "node table", dev)
    _check(tables.leaf, torch.float32,
           (m, bvh_mod.leaf_width(tables.max_leaf)), "leaf table", dev)
    if not 1 <= tables.max_leaf <= MAX_LEAF:
        raise ValueError(f"max_leaf {tables.max_leaf} outside 1..{MAX_LEAF}")
    _check(tables.node32, torch.float32, (m, 8), "32-byte node table", dev)
    if (tables.node.data_ptr() % 16 or tables.node32.data_ptr() % 16
            or tables.leaf.data_ptr() % 16):
        raise ValueError("node and leaf tables: the kernels read float4 and "
                         "copy treelets by TMA, so they must start on a "
                         "16-byte boundary")
    if counts is None:
        counts = torch.zeros((N_COUNTS,), dtype=torch.int64, device=dev)
    _check(counts, torch.int64, (N_COUNTS,), "counts", dev)
    return counts


def _raise_on(lib, rc, name):
    if rc != 0:
        raise RuntimeError(
            f"{name}_launch failed: CUDA error {rc} "
            f"({lib.treelet_kernel_error_string(rc).decode()})")


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _launch_walk(feats, tables, any_hit, counts):
    from light_transport_tpu_torch.ops._build import load_treelet_kernel

    counts = _operands(feats, tables, counts)
    n = feats.shape[1]
    kw = dict(device=feats.device)
    best_t = torch.empty((n,), dtype=torch.float32, **kw)
    best_tri = torch.empty((n,), dtype=torch.int32, **kw)
    visits = torch.empty((n,), dtype=torch.int32, **kw)
    if n:
        lib = load_treelet_kernel()
        rc = lib.treelet_walk_launch(
            _ptr(feats), n, _ptr(tables.node32), _ptr(tables.leaf),
            tables.leaf.shape[1], tables.max_leaf, tables.num_nodes,
            int(any_hit), _ptr(best_t), _ptr(best_tri), _ptr(visits),
            _ptr(counts), _stream(feats.device))
        _raise_on(lib, rc, "treelet_walk")
        LAUNCHES["treelet_walk"] += 1
    return best_t, best_tri, visits


def _launch_resume(feats, tables, perm, lanes, max_loads, any_hit, gate,
                   counts):
    from light_transport_tpu_torch.ops._build import load_treelet_kernel

    counts = _operands(feats, tables, counts)
    dev = feats.device
    n = feats.shape[1]
    _check(perm, torch.int64, (n,), "perm", dev)
    for name, t, dtype in zip(Lanes._fields, lanes,
                              (torch.int32, torch.float32, torch.int32,
                               torch.int32)):
        _check(t, dtype, (n,), name, dev)
    for name, t in zip(("gate_in", "gate_out"), gate):
        if t is not None:
            _check(t, torch.int32, (1,), name, dev)
    if n:
        lib = load_treelet_kernel()
        rc = lib.treelet_resume_launch(
            _ptr(feats), n, _ptr(perm), _ptr(tables.node), _ptr(tables.leaf),
            tables.leaf.shape[1], tables.max_leaf, tables.num_nodes,
            tables.T, max_loads, int(any_hit), *(_ptr(t) for t in lanes),
            *(_ptr(t) for t in gate), _ptr(counts), _stream(dev))
        _raise_on(lib, rc, "treelet_resume")
        LAUNCHES["treelet_resume"] += 1
    return lanes


def _device_type(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def treelet_walk(feats, tables: TreeletTables, any_hit=False, counts=None):
    """K5: every lane walked from the root in one launch; for CPU tensors
    :func:`treelet_walk_reference`.  Returns (best_t, best_tri, visits)
    per padded ray (``best_tri`` -1: no hit)."""
    if _device_type(feats, "treelet_walk") == "cuda":
        return _launch_walk(feats, tables, any_hit, counts)
    return treelet_walk_reference(feats, tables, any_hit)


def treelet_resume(feats, tables: TreeletTables, perm, lanes: Lanes,
                   max_loads: int, any_hit=False, gate=(None, None),
                   counts=None) -> Lanes:
    """K5r: thread ``i`` resumes lane ``perm[i]`` (int64 ids, a
    permutation of the lanes) from its cursor, ``best_t`` and ``best_tri``,
    bounded to ``max_loads`` treelets (0: no bound), and updates ``lanes``
    in place; ``gate = (gate_in, gate_out)``, int32 (1,) tensors or None:
    the launch does nothing when ``gate_in`` holds 0 and adds the lanes it
    leaves unfinished to ``gate_out``.  For CPU tensors
    :func:`treelet_resume_reference`.  Returns ``lanes``."""
    if max_loads < 0:
        raise ValueError(f"max_loads {max_loads} < 0")
    if _device_type(feats, "treelet_resume") == "cuda":
        return _launch_resume(feats, tables, perm, lanes, max_loads, any_hit,
                              gate, counts)
    return treelet_resume_reference(feats, tables, perm, lanes, max_loads,
                                    any_hit, gate)


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


def _sorted_lanes(lanes: Lanes, first: bool):
    """The pass's permutation: the lanes by cursor, finished lanes (cursor
    >= M) last, ties in lane order; before the first pass every cursor is
    0 and the order is the identity."""
    if first:
        return torch.arange(lanes.cursor.shape[0], device=lanes.cursor.device)
    return torch.argsort(lanes.cursor, stable=True)


def _passes_run(gates, n_lanes: int, bounded: int) -> int:
    """The passes that found a live lane, of ``bounded`` bounded ones whose
    gate words are ``gates``, plus the unbounded last (one host read)."""
    if not bounded:
        return 1
    live_before = [n_lanes > 0] + (gates[:bounded - 1] > 0).tolist()
    return 1 + sum(live_before)


def intersect_bvh_treelet_wavefront(
        origins, directions, tables: TreeletTables, t_min=T_EPS,
        t_max=float("inf"), any_hit: bool = False,
        ray_tile: int = DEFAULT_R, with_stats: bool = False,
        loads_per_pass: int = 1, max_passes: int = 12):
    """``max_passes`` sorted K5r passes of ``loads_per_pass`` treelets, then
    one unbounded pass that walks the stragglers to the end, so
    ``max_passes`` changes the time, never the result.  Each pass sorts a
    permutation of the lanes by cursor and is gated on the device by the
    unfinished-lane count of the pass before: once every lane has finished
    the remaining launches return at once, and nothing is read back to the
    host.  Bitwise equal to the roped walk and the other drivers."""
    n = origins.shape[0]
    feats, n_pad = _make_feats(origins, directions, t_min, t_max, ray_tile)
    lanes = Lanes.start(feats)
    gates = torch.zeros((max_passes + 1,), dtype=torch.int32,
                        device=feats.device)
    gate_in = None
    for p in range(max_passes + 1):
        bounded = p < max_passes
        treelet_resume(feats, tables, _sorted_lanes(lanes, p == 0), lanes,
                       loads_per_pass if bounded else 0, any_hit,
                       (gate_in, gates[p:p + 1]))
        gate_in = gates[p:p + 1]
    passes = _passes_run(gates, n_pad, max_passes) if with_stats else None
    return _result(lanes.best_t, lanes.best_tri, lanes.visits, n, any_hit,
                   with_stats, passes)


def intersect_bvh_treelet_queued(
        origins, directions, tables: TreeletTables, t_min=T_EPS,
        t_max=float("inf"), any_hit: bool = False,
        ray_tile: int = DEFAULT_R, with_stats: bool = False,
        loads_per_pass: int = 4, passes_per_sync: int = 8,
        max_sync_rounds: int = 4096):
    """Sorted, device-gated passes of ``loads_per_pass`` treelets,
    ``passes_per_sync`` of them between host checks of the last pass's
    unfinished-lane count, until every lane has finished.  Same contract
    as :func:`intersect_bvh_treelet`."""
    if loads_per_pass < 1:
        raise ValueError(f"loads_per_pass {loads_per_pass} < 1")
    if passes_per_sync < 1:
        raise ValueError(f"passes_per_sync {passes_per_sync} < 1")
    n = origins.shape[0]
    feats, _ = _make_feats(origins, directions, t_min, t_max, ray_tile)
    lanes = Lanes.start(feats)
    gate_in = None
    passes = 0
    for _ in range(max_sync_rounds):
        gates = torch.zeros((passes_per_sync,), dtype=torch.int32,
                            device=feats.device)
        for p in range(passes_per_sync):
            treelet_resume(feats, tables,
                           _sorted_lanes(lanes, gate_in is None), lanes,
                           loads_per_pass, any_hit, (gate_in, gates[p:p + 1]))
            gate_in = gates[p:p + 1]
        passes += passes_per_sync
        if int(gates[-1]) == 0:
            break
    else:
        raise RuntimeError(f"treelet wavefront did not converge in "
                           f"{max_sync_rounds * passes_per_sync} passes")
    return _result(lanes.best_t, lanes.best_tri, lanes.visits, n, any_hit,
                   with_stats, passes)
