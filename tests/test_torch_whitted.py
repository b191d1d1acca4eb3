"""The port's Whitted integrator against the JAX package on the CPU: the
unrolled tree and the weighted ray queue on the Cornell box from JAX's
own jittered camera rays (``tests/test_whitted.py``'s), the indirect
term in both modes from JAX's hemisphere draws, the glass preset through
the port's plain K3, the port's queue against its unrolled tree, and
``api.render(integrator="whitted")``'s argument checks.

JAX's recursion and its queue step run unjitted around its ``_hit`` and
``_shade_local`` compiled with the tests' ``CHEAP_COMPILE`` options: the
same functions, compiled in pieces (XLA's fusion of a whole queue step
rounds a few grazing shadow rays of the indirect children apart from the
pieces, and from the port).  Tolerances: atol 1e-4 on every
pixel of the Cornell box (no coincident surfaces there); on ``glass``,
whose body and liquid share coincident triangles of opposite facing, the
pixels whose tree meets such a tie (the two sides' intersectors round the
equal distances apart and pick different triangles) are named, and the
rest held to atol 1e-4; the port's queue against its unrolled tree
within 6e-3, ``tests/test_whitted.py``'s bound for the dropped sub-cutoff
subtrees.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.integrators import whitted as jw
from light_transport_tpu.integrators.path_tracer import camera_rays
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.scene.cornell import cornell_box_scene
from light_transport_tpu_torch import api
from light_transport_tpu_torch.integrators import whitted as tw
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.utils import interop
from test_torch_analytic import jax_scene_tables
from test_torch_render import CHEAP_COMPILE, mt_float64, port_cfg

torch.set_num_threads(1)

J_HIT = jax.jit(jw._hit, static_argnums=3, compiler_options=CHEAP_COMPILE)
J_SHADE = jax.jit(jw._shade_local, static_argnums=4,
                  compiler_options=CHEAP_COMPILE)


def jax_pieces(hit=J_HIT):
    """JAX's Whitted with its pieces compiled cheaply and its queue step
    unjitted (see the module docstring); ``hit`` may wrap the nearest-hit
    query."""
    return mock.patch.multiple(jw, _hit=hit, _shade_local=J_SHADE,
                               _queue_step=jw._queue_step.__wrapped__)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box at 16x16, depth 3, on both sides, and JAX's
    jittered camera rays of ``tests/test_whitted.py:78-83``."""
    js, jcfg = cornell_box_scene(width=16, height=16, spp=1, max_depth=3)
    n = jcfg.width * jcfg.height
    u_aa = jax.random.uniform(jax.random.key(4), (n, 2))
    o, d = jax.jit(lambda u: camera_rays(js, jcfg, u),
                   compiler_options=CHEAP_COMPILE)(u_aa)
    scene = interop.scene_from_numpy(jax_scene_tables(js), device="cpu")
    return dict(js=js, jcfg=jcfg, scene=scene, cfg=port_cfg(jcfg), o=o, d=d,
                to=t(o), td=t(d))


def test_trace_whitted_matches_jax(cornell):
    c = cornell
    with jax_pieces():
        want = np.asarray(jw.trace_whitted(c["js"], c["o"], c["d"], 3))
    got = tw.trace_whitted(c["scene"], c["to"], c["td"], 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got.mean() > 0.05


def fold_draws(key, iters, gi):
    """JAX's queue draws: superstep ``it``'s (k, N, 2) uniforms from
    ``fold_in(fold_in(key, it), s)``, k = gi at the first step, else 1."""
    def one(it, n):
        k = jax.random.fold_in(key, it)
        return np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(k, s), (n, 2), jnp.float32))
            for s in range(gi if it == 0 else 1)])
    return one


@pytest.mark.parametrize("mode", ["queue", "full", "primary"])
def test_queue_and_indirect_match_jax(cornell, mode):
    """On the jittered rays: ``queue``, trace_whitted_queue at depth 5;
    ``full``, the queue at depth 3 with two indirect children at the
    primary node and one at every other (render_whitted's
    ``indirect_mode="full"``); ``primary``, the indirect term at the
    primary hit over the unrolled tree (its ``"primary"``).  The indirect
    modes take JAX's own hemisphere draws."""
    c = cornell
    key = jax.random.key(2)
    n = c["to"].shape[0]
    if mode == "primary":
        with jax_pieces():
            want = np.asarray(jw._indirect_diffuse(
                c["js"], c["o"], c["d"], key, 2,
                lambda oo, dd: jw.trace_whitted(c["js"], oo, dd, 2), None))
        uniforms = t(np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(key, s), (n, 2))) for s in range(2)]))
        got = tw._indirect_diffuse(
            c["scene"], c["to"], c["td"], 2,
            lambda oo, dd: tw.trace_whitted(c["scene"], oo, dd, 2), None,
            uniforms=uniforms).numpy()
        assert (got >= 0).all() and got.mean() > 1e-4
    else:
        depth, gi = (5, 0) if mode == "queue" else (3, 2)
        with jax_pieces():
            want = np.asarray(jw.trace_whitted_queue(
                c["js"], c["o"], c["d"], depth, indirect_samples=gi,
                key=key))
        iters = 2 ** (depth + 1) - 1 + gi * (2 * depth + 1)
        draw = fold_draws(key, iters, gi)
        stats = {}
        got = tw.trace_whitted_queue(
            c["scene"], c["to"], c["td"], depth, indirect_samples=gi,
            uniforms=[t(draw(it, n)) for it in range(iters)] if gi else None,
            stats=stats).numpy()
        assert 1 < stats["supersteps"] < iters
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_queue_matches_unrolled_in_the_port(cornell):
    c = cornell
    unrolled = tw.trace_whitted(c["scene"], c["to"], c["td"], 3)
    stats = {}
    queued = tw.trace_whitted_queue(c["scene"], c["to"], c["td"], 3,
                                    stats=stats)
    np.testing.assert_allclose(queued.numpy(), unrolled.numpy(), atol=6e-3)
    assert stats["supersteps"] <= 2 ** 4 - 1
    # render_whitted queues past depth 4 and still renders the box
    deep = tw.render_whitted(c["scene"], dataclasses.replace(c["cfg"],
                                                             max_depth=6))
    assert torch.isfinite(deep).all() and float(deep.mean()) > 0.05


def tree_parents(depth):
    """Each node's parent, in the order trace_whitted visits the nodes
    (reflection subtree, then refraction subtree)."""
    parents = []

    def visit(parent, left):
        me = len(parents)
        parents.append(parent)
        if left > 0:
            visit(me, left - 1)
            visit(me, left - 1)

    visit(-1, depth)
    return parents


def tie_pixels(scene, jcalls, calls, depth):
    """(pixels whose tree meets a tie or an edge, pixels whose tree
    diverges otherwise): per node, the lanes where the two sides' nearest
    hits first differ though every ancestor agreed; a tie when both hit
    triangles that the port's ray meets at the same float64 distance, an
    edge when one side misses and the other's hit lies on an edge."""
    parents = tree_parents(depth)
    assert len(calls) == len(jcalls) == len(parents)
    verts = scene.mesh.vertices()
    n = calls[0][0].shape[0]
    clean, tie, other = {-1: np.ones(n, bool)}, np.zeros(n, bool), \
        np.zeros(n, bool)
    for k, (parent, (o, d, active, hit), jhit) in enumerate(
            zip(parents, calls, jcalls)):
        act = np.ones(n, bool) if active is None else active.numpy()
        # JAX's BVH walk answers inactive lanes too: mask both by the
        # port's node (the same lanes while every ancestor agrees)
        ok = hit.valid.numpy() & act
        tri = np.where(ok, hit.tri.numpy(), -1)
        jtri = np.where(np.asarray(jhit.valid) & act, np.asarray(jhit.tri),
                        -1)
        first = clean[parent] & (tri != jtri)
        clean[k] = clean[parent] & ~first
        lanes = np.nonzero(first)[0]
        a, b = tri[lanes], jtri[lanes]
        oo, dd = o.double().numpy()[lanes], d.double().numpy()[lanes]
        ta = mt_float64(verts[a], oo, dd)[0]
        tb = mt_float64(verts[b], oo, dd)[0]
        is_tie = (a >= 0) & (b >= 0) & (np.abs(ta - tb) <= 1e-6 * ta)
        # one side slips through a shared edge: the other's hit lies on it
        _, u, v = mt_float64(verts[np.maximum(a, b)], oo, dd)
        on_edge = ((a < 0) != (b < 0)) & (
            np.minimum(np.minimum(u, v), 1 - u - v) <= 1e-6)
        tie[lanes[is_tie | on_edge]] = True
        other[lanes[~is_tie & ~on_edge]] = True
    return tie, other


def test_render_whitted_glass_matches_jax():
    """``glass_scene`` at 16x16, depth 3: JAX's BVH walk against the
    port's plain K3, the nearest hit of every tree node recorded on both
    sides."""
    js, jcfg = jpresets.glass_scene(16, 16, 1, 3)
    scene = interop.scene_from_numpy(jax_scene_tables(js), device="cpu")
    cfg = port_cfg(jcfg)
    jcalls, calls = [], []

    def jhit(*a, **k):
        out = J_HIT(*a, **k)
        jcalls.append(out)
        return out

    def hit(scene_, o, d, ray_chunk, active=None):
        out = tw.scene_intersect(scene_, o, d, ray_chunk=ray_chunk,
                                 active=active)
        calls.append((o, d, active, out))
        return out

    with jax_pieces(hit=jhit):
        want = np.asarray(jw._render_whitted_unrolled.__wrapped__(
            js, jcfg, jax.random.key(0), None, 0))
    with mock.patch.object(tw, "_hit", hit):
        got = tw.render_whitted(scene, cfg).numpy()
    tie, other = tie_pixels(scene, jcalls, calls, 3)
    close = (np.abs(got - want) <= 1e-4).all(-1).reshape(-1)
    plain = ~tie & ~other
    # 93 of the 256 pixels meet a body/liquid tie, one (lane 30, a camera
    # ray through a pixel corner) an edge that JAX's walk slips through;
    # no tree diverges otherwise, and the other 162 hold to 1e-4
    assert tie.mean() < 0.5 and not other.any(), (tie.sum(),
                                                  np.nonzero(other)[0])
    assert close[plain].mean() >= 0.99, np.nonzero(plain & ~close)[0]
    assert got.mean() > 0.01


def test_api_render_whitted():
    scene, cfg = presets.hard_shadow_scene(24, 24, device="cpu")
    img = api.render(scene, cfg, integrator="whitted")
    assert img.shape == (24, 24, 3) and img.device.type == "cpu"
    assert torch.equal(img, tw.render_whitted(scene, cfg))
    # one deterministic ray a pixel: the seed changes nothing
    assert torch.equal(img, api.render(scene, cfg, seed=5,
                                       integrator="whitted"))
    assert 0.0 < float(img.mean()) < 1.0
    # the indirect term, its uniforms drawn from the seed, adds light
    for mode in ("primary", "full"):
        ind = tw.render_whitted(scene, cfg, seed=3, indirect_samples=2,
                                indirect_mode=mode)
        assert float(ind.mean()) > float(img.mean())
        assert torch.equal(ind, tw.render_whitted(
            scene, cfg, seed=3, indirect_samples=2, indirect_mode=mode))
    for change in (dict(aperture=0.1), dict(sampler="sobol"),
                   dict(emission_mode="mis", nee_mode="all")):
        with pytest.raises(ValueError):
            api.render(scene, dataclasses.replace(cfg, **change),
                       integrator="whitted")
    bdpt = api.render(scene, cfg, integrator="bdpt")
    assert bdpt.shape == img.shape and torch.isfinite(bdpt).all()
    adaptive = api.render(scene, cfg, integrator="adaptive")
    assert adaptive.shape == img.shape and torch.isfinite(adaptive).all()
    with pytest.raises(ValueError, match="unknown integrator"):
        api.render(scene, cfg, integrator="photon")
    with pytest.raises(ValueError, match="indirect_mode"):
        tw.render_whitted(scene, cfg, indirect_mode="all")
