"""K5r's plain version through a permutation, the in-place wavefront and
its gate words on the CPU, in plain torch: each is held bitwise against
the plain roped walk (``accel.bvh.roped_walk`` and ``intersect_bvh``) and
against the single-launch and queued drivers, in cursor, best_t,
best_tri and per-ray visits, nearest and any hit.  (The drivers are held
against JAX's walk in ``test_torch_treelet_render.py``.)

The mesh and rays are made from seeds with numpy, as
``tests/test_treelet.py`` makes them: 2,000 random triangles cut into
treelets of 64 nodes, 700 rays (every third one dead, padded to tiles of
256 lanes).
"""

import functools

import numpy as np
import pytest
import torch

from light_transport_tpu_torch.accel import bvh
from light_transport_tpu_torch.ops import treelet_kernel as tk
from light_transport_tpu_torch.scene.geometry import TriangleMesh

torch.set_num_threads(1)

N_TRIS, N_RAYS, T, R = 2000, 700, 64, 256
MAX_DIST = 4.0
MODES = {"nearest": False, "any hit": True}


@functools.lru_cache(maxsize=None)
def scene():
    rng = np.random.default_rng(N_TRIS)
    base = rng.uniform(-4.0, 4.0, size=(N_TRIS, 1, 3))
    tris = base + rng.normal(scale=0.4, size=(N_TRIS, 3, 3))
    mesh = TriangleMesh.build(tris, np.zeros(N_TRIS, np.int32), device="cpu")
    b, mesh = bvh.build(mesh)
    rng = np.random.default_rng(N_TRIS + 1)
    o = rng.uniform(-6.0, 6.0, size=(N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dead = np.arange(N_RAYS) % 3 == 0
    return (mesh, b, tk.build_treelet_tables(b, T=T), torch.from_numpy(o),
            torch.from_numpy(d), torch.from_numpy(dead))


def t_max(any_hit):
    *_, dead = scene()
    return torch.where(dead, float("-inf"), MAX_DIST if any_hit
                       else float("inf"))


def feats_of(any_hit):
    _, _, tab, o, d, _ = scene()
    feats, n_pad = tk._make_feats(o, d, tk.T_EPS, t_max(any_hit), R)
    assert n_pad == 768 and n_pad > N_RAYS  # padding lanes included
    return feats


def walk_in_order(feats, tab, lanes, max_loads, any_hit):
    """The roped walk of every lane in lane order, from ``lanes``."""
    cursor, best_t, best_tri, visits = bvh.roped_walk(
        tab.node, tab.leaf, tab.num_nodes, tab.max_leaf, feats[0:3].T,
        feats[3:6].T, feats[6:9].T, feats[9], lanes.cursor, lanes.best_t,
        lanes.best_tri, any_hit=any_hit, T=tab.T, max_loads=max_loads)
    return tk.Lanes(cursor, best_t, best_tri, lanes.visits + visits)


def assert_lanes_equal(got, want):
    for name, a, b in zip(tk.Lanes._fields, got, want):
        assert torch.equal(a, b), (name, int((a != b).sum()))


def copy(lanes):
    return tk.Lanes(*(t.clone() for t in lanes))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resume_through_perm_matches_walk(mode):
    """Bounded passes of one treelet, each through a random permutation
    and then the unbounded one: after every pass the lane state equals
    the roped walk's in lane order, and the gate word counts the lanes
    left unfinished."""
    any_hit = MODES[mode]
    _, _, tab, *_ = scene()
    feats = feats_of(any_hit)
    g = torch.Generator().manual_seed(5)
    lanes = tk.Lanes.start(feats)
    want = copy(lanes)
    for max_loads in (1, 1, 1, 0):
        perm = torch.randperm(feats.shape[1], generator=g)
        gate = torch.zeros((1,), dtype=torch.int32)
        got = tk.treelet_resume(feats, tab, perm, lanes, max_loads, any_hit,
                                (None, gate))
        assert got is lanes  # in place
        want = walk_in_order(feats, tab, want, max_loads, any_hit)
        assert_lanes_equal(lanes, want)
        assert int(gate) == int((lanes.cursor < tab.num_nodes).sum())
    assert int(gate) == 0 and (lanes.cursor >= tab.num_nodes).all()


def test_dead_and_padding_lanes():
    """Dead lanes and the padding lanes die at the root in the first pass
    (one visit, no hit) and no later pass touches them or any other lane
    that has finished."""
    _, _, tab, *_ = scene()
    *_, dead = scene()
    feats = feats_of(False)
    lanes = tk.Lanes.start(feats)
    perm = torch.arange(feats.shape[1])
    tk.treelet_resume(feats, tab, perm, lanes, 1)
    idle = torch.cat([dead, torch.ones(feats.shape[1] - N_RAYS,
                                       dtype=torch.bool)])
    assert (lanes.visits[idle] == 1).all()
    assert (lanes.best_tri[idle] == -1).all()
    assert (lanes.cursor[idle] >= tab.num_nodes).all()
    done = lanes.cursor >= tab.num_nodes
    before = copy(lanes)
    tk.treelet_resume(feats, tab, perm.flip(0), lanes, 1)
    for a, b in zip(lanes, before):
        assert torch.equal(a[done], b[done])
    assert (lanes.visits[~done] > before.visits[~done]).all()


def test_tile_straddles_two_treelets():
    """After one bounded pass from the root the unfinished lanes sit on
    the first node of their second treelet; sorted by cursor, tiles of 32
    lanes hold lanes of two treelets (a block stages one of them).  A
    bounded pass through that order ends each lane at its own next
    treelet, as the roped walk does."""
    _, _, tab, *_ = scene()
    feats = feats_of(False)
    lanes = tk.Lanes.start(feats)
    tk.treelet_resume(feats, tab, torch.arange(feats.shape[1]), lanes, 1)
    perm = tk._sorted_lanes(lanes, False)
    treelet = torch.where(lanes.cursor < tab.num_nodes,
                          lanes.cursor // tab.T, -1)[perm]
    tiles = treelet[:(treelet.shape[0] // 32) * 32].view(-1, 32)
    live = tiles[:, 0] >= 0
    straddle = live & (tiles[:, 0] != tiles[:, -1]) & (tiles[:, -1] >= 0)
    assert straddle.any()
    start = lanes.cursor.clone()
    want = walk_in_order(feats, tab, copy(lanes), 1, False)
    tk.treelet_resume(feats, tab, perm, lanes, 1)
    assert_lanes_equal(lanes, want)
    moved = (start < tab.num_nodes) & (lanes.cursor < tab.num_nodes)
    assert moved.any()
    assert (lanes.cursor[moved] // tab.T > start[moved] // tab.T).all()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_wavefront_matches_walk_and_drivers(mode):
    """The in-place, gated wavefront equals the roped walk from the root
    (``intersect_bvh``), one K5 launch and the queued driver bitwise, with
    the same per-ray visits, at every number of bounded passes."""
    any_hit = MODES[mode]
    mesh, b, tab, o, d, dead = scene()
    tm = t_max(any_hit)
    ref = bvh.intersect_bvh(o, d, mesh, b, t_max=tm, any_hit=any_hit)
    single, s_stats = tk.intersect_bvh_treelet(
        o, d, tab, t_max=tm, any_hit=any_hit, with_stats=True)
    queued, q_stats = tk.intersect_bvh_treelet_queued(
        o, d, tab, t_max=tm, any_hit=any_hit, with_stats=True,
        loads_per_pass=2, passes_per_sync=3)
    for got in (single, queued):
        if any_hit:
            assert torch.equal(got, ref.valid)
        else:
            for k in ("valid", "tri", "t"):
                assert torch.equal(getattr(got, k), getattr(ref, k)), k
    assert torch.equal(q_stats["visits"], s_stats["visits"])
    assert q_stats["passes"] % 3 == 0
    for max_passes in (0, 1, 3, 12):
        hit, stats = tk.intersect_bvh_treelet_wavefront(
            o, d, tab, t_max=tm, any_hit=any_hit, with_stats=True,
            max_passes=max_passes)
        assert torch.equal(stats["visits"], s_stats["visits"])
        if any_hit:
            assert torch.equal(hit, ref.valid)
        else:
            for k in ("valid", "tri", "t"):
                assert torch.equal(getattr(hit, k), getattr(ref, k)), k
    assert not ref.valid[dead].any() and ref.valid.any()


def test_gate_ends_a_wave_before_max_passes(monkeypatch):
    """A wave that finishes in fewer passes than ``max_passes``: the gate
    word of its last live pass is 0, every later launch (the unbounded one
    included) returns at once and leaves the lanes as they are, and the
    passes counted are those that found a live lane, plus the last."""
    _, _, tab, o, d, _ = scene()
    calls = []
    real = tk.treelet_resume_reference

    def spy(feats, tables, perm, lanes, max_loads, any_hit=False,
            gate=(None, None)):
        before = copy(lanes)
        real(feats, tables, perm, lanes, max_loads, any_hit, gate)
        calls.append((gate[0] is None or int(gate[0]) > 0,
                      int(gate[1]), all(torch.equal(a, b) for a, b in
                                        zip(lanes, before))))
        return lanes

    monkeypatch.setattr(tk, "treelet_resume_reference", spy)
    hit, stats = tk.intersect_bvh_treelet_wavefront(
        o, d, tab, any_hit=True, t_max=t_max(True), with_stats=True,
        loads_per_pass=4, max_passes=30)
    assert len(calls) == 31
    ran = [c[0] for c in calls]
    k = ran.index(False)  # the first gated launch
    assert 1 < k < 30 and not any(ran[k:]) and all(ran[:k])
    assert calls[k - 1][1] == 0 and all(c[1] == 0 for c in calls[k:])
    assert all(c[2] for c in calls[k:])  # gated launches change nothing
    assert stats["passes"] == k + 1
    single = tk.intersect_bvh_treelet(o, d, tab, t_max=t_max(True),
                                      any_hit=True)
    assert torch.equal(hit, single)
    # a gate word of 0 stops a launch even while lanes are unfinished
    feats = feats_of(False)
    lanes = tk.Lanes.start(feats)
    zero = torch.zeros((1,), dtype=torch.int32)
    out = torch.zeros((1,), dtype=torch.int32)
    real(feats, tab, torch.arange(feats.shape[1]), lanes, 1, False,
         (zero, out))
    assert_lanes_equal(lanes, tk.Lanes.start(feats))
    assert int(out) == 0
