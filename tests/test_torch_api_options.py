"""The keywords the port takes from JAX's API, on the CPU: the split
tracer's ``stack_size`` and ``max_iters`` (its full-stack fallback
included), the Whitted queue's ``weight_cutoff`` and ``max_iters``,
``cv_correct``'s ``eps``, and a guard that every keyword of a public JAX
function is accepted by the port function of the same name.

JAX's split step is compiled with the tests' ``CHEAP_COMPILE`` options,
its Whitted queue runs unjitted around its pieces compiled so
(``tests/test_torch_whitted.py``).  Tolerances: the split tracer as
``tests/test_torch_split.py`` holds it (>= 99 % of lanes within rtol
1e-4, atol 1e-6, means within 1e-3); the queue against JAX atol 1e-4 on
every pixel of the Cornell box; the port's queue at the tight cutoff
against its unrolled tree on glass to ``tests/test_whitted.py:132-171``'s
limits (atol 2e-2 at the default cutoff; at 1e-5 the 95th percentile of
the difference below 2e-3 and its maximum below 5e-2).
"""

import dataclasses
import importlib
import inspect
import pkgutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import light_transport_tpu
import light_transport_tpu_torch
from light_transport_tpu.core.config import RenderConfig as JRenderConfig
from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.integrators import whitted as jw
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.scene import geometry as jgeo
from light_transport_tpu.scene import material as jmat
from light_transport_tpu.scene import scene as jscene
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators import control_variates as cv
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.integrators import whitted as tw
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.utils import interop
from test_torch_render import CHEAP_COMPILE, jax_scene_arrays, lanes_close
from test_torch_split import (
    SLAB_CFG,
    numpy_uniforms,
    port_slab,
    slab_rays,
    slab_scene,
    t,
)
from test_torch_whitted import cornell, jax_pieces  # noqa: F401 (fixture)

torch.set_num_threads(1)

# JAX's split step at CHEAP_COMPILE (S is static: one compile a stack size)
J_SPLIT = jax.jit(jpt._split_step.__wrapped__, static_argnums=(1, 7, 8),
                  compiler_options=CHEAP_COMPILE)


def jax_split(js, jcfg, o, d, uni, **kw):
    with mock.patch.object(jpt, "_split_step", J_SPLIT):
        return np.asarray(jpt.trace_paths_split(
            js, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(uni), **kw))


@pytest.fixture(scope="module", params=["slab", "glass"])
def split_inputs(request):
    """Both sides' scene and config and the same rays and uniforms: the
    slab (64 tilted rays, depth 6) and the glass preset (16x16x2, depth 8,
    JAX's camera rays), where a lane's stack of 1 or 2 slots fills."""
    if request.param == "slab":
        js = slab_scene(jgeo, jmat, jscene)
        jcfg = JRenderConfig(**SLAB_CFG)
        scene = port_slab()
        o, d = slab_rays(64, spread=0.4, seed=1)
    else:
        js, jcfg = jpresets.glass_scene(16, 16, 2, 8)
        scene = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
        n = jcfg.width * jcfg.height * jcfg.spp
        u_aa = np.random.default_rng(2).random((n, 2)).astype(np.float32)
        o, d = (np.asarray(a) for a in jax.jit(
            lambda u: jpt.camera_rays(js, jcfg, u),
            compiler_options=CHEAP_COMPILE)(u_aa))
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    uni = numpy_uniforms(o.shape[0], cfg.max_depth, seed=3)
    return dict(js=js, jcfg=jcfg, scene=scene, cfg=cfg, o=o, d=d, uni=uni)


@pytest.mark.parametrize("stack_size", [1, 2])
def test_split_stack_size_matches_jax(split_inputs, stack_size):
    s = split_inputs
    jrad = jax_split(s["js"], s["jcfg"], s["o"], s["d"], s["uni"],
                     stack_size=stack_size)
    rad = pt.trace_paths_split(s["scene"], s["cfg"], t(s["o"]), t(s["d"]),
                               t(s["uni"]), stack_size=stack_size).numpy()
    close = lanes_close(rad, jrad)
    assert close.mean() >= 0.99, close.mean()
    assert rad.mean() > 0.01 and np.isfinite(rad).all()
    assert abs(rad.mean() - jrad.mean()) < 1e-3


def test_split_stack_size_on_the_slab():
    """At normal incidence the default stack never fills and the estimate
    does not depend on the uniforms; a stack of one slot fills at the
    second split, and the fallback's sampled branches move the lanes.  A
    stack above the depth is the default bitwise, the same iterations;
    no slot at all is the stochastic tracer bitwise."""
    scene, cfg = port_slab(), RenderConfig(**SLAB_CFG)
    o, d = (t(a) for a in slab_rays(64))
    u = t(numpy_uniforms(64, cfg.max_depth, 4))
    runs = {}
    for size in (None, 1, 10, 0):
        stats = {}
        runs[size] = (pt.trace_paths_split(scene, cfg, o, d, u,
                                           stack_size=size, stats=stats),
                      stats["iterations"])
    default, one = runs[None][0], runs[1][0]
    other = pt.trace_paths_split(scene, cfg, o, d,
                                 t(numpy_uniforms(64, cfg.max_depth, 5)))
    np.testing.assert_allclose(default.numpy(), other.numpy(), atol=1e-6)
    assert bool(((one - default).abs().amax(dim=1) > 1e-3).any())
    assert torch.equal(runs[10][0], default) and runs[10][1] == runs[None][1]
    assert torch.equal(runs[0][0], pt.trace_paths(scene, cfg, o, d, u)[0])


def test_split_max_iters():
    """``max_iters=2`` stops after two iterations with what the lanes
    gathered, as JAX does; 0 means the default bound, as JAX's ``or``
    makes it."""
    js, jcfg = slab_scene(jgeo, jmat, jscene), JRenderConfig(**SLAB_CFG)
    scene, cfg = port_slab(), RenderConfig(**SLAB_CFG)
    o, d = slab_rays(64, spread=0.4, seed=1)
    uni = numpy_uniforms(64, cfg.max_depth, seed=3)
    stats = {}
    cut = pt.trace_paths_split(scene, cfg, t(o), t(d), t(uni), max_iters=2,
                               stats=stats)
    assert stats["iterations"] == 2
    jcut = jax_split(js, jcfg, o, d, uni, max_iters=2)
    assert lanes_close(cut.numpy(), jcut).mean() >= 0.99
    full = pt.trace_paths_split(scene, cfg, t(o), t(d), t(uni))
    assert float(cut.sum()) < float(full.sum())
    assert torch.equal(pt.trace_paths_split(scene, cfg, t(o), t(d), t(uni),
                                            max_iters=0), full)


def test_whitted_queue_options_match_jax(cornell):  # noqa: F811
    """The queue at depth 5 with ``weight_cutoff=1e-5`` and with
    ``max_iters=3`` against JAX's on the jittered Cornell rays;
    ``max_iters=0`` runs no superstep and gives zeros."""
    c = cornell
    for kw in (dict(weight_cutoff=1e-5), dict(max_iters=3)):
        with jax_pieces():
            want = np.asarray(jw.trace_whitted_queue(c["js"], c["o"], c["d"],
                                                     5, **kw))
        stats = {}
        got = tw.trace_whitted_queue(c["scene"], c["to"], c["td"], 5,
                                     stats=stats, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert got.mean() > 0.05
        if "max_iters" in kw:
            assert stats["supersteps"] == 3
    stats = {}
    zero = tw.trace_whitted_queue(c["scene"], c["to"], c["td"], 5,
                                  max_iters=0, stats=stats)
    assert stats["supersteps"] == 0 and not zero.any()
    assert zero.shape == c["to"].shape


def test_whitted_queue_tight_cutoff_on_glass():
    """``tests/test_whitted.py:132-171`` on the port: glass 12x12 at depth
    4, the queue against the unrolled tree, at the default cutoff and at
    1e-5, which shades more of the tree."""
    scene, cfg = presets.glass_scene(12, 12, 1, 4, device="cpu")
    n = cfg.height * cfg.width
    u_aa = torch.from_numpy(
        np.random.default_rng(9).random((n, 2)).astype(np.float32))
    o, d = pt.camera_rays(scene, cfg, u_aa)
    unrolled = tw.trace_whitted(scene, o, d, 4).numpy()
    steps = {}
    for cut in (tw.WEIGHT_CUTOFF, 1e-5):
        stats = {}
        queued = tw.trace_whitted_queue(scene, o, d, 4, weight_cutoff=cut,
                                        stats=stats).numpy()
        steps[cut] = stats["supersteps"]
        err = np.abs(queued - unrolled)
        assert err.max() < 2e-2, (cut, err.max())
    assert np.quantile(err, 0.95) < 2e-3, np.quantile(err, [0.5, 0.95, 1])
    assert err.max() < 5e-2
    assert steps[1e-5] > steps[tw.WEIGHT_CUTOFF], steps
    assert unrolled.mean() > 0.01


def test_cv_correct_takes_eps():
    r = np.random.default_rng(6)
    samples = t(r.random((5, 16, 3), dtype=np.float32))
    control = t(r.random((5, 16, 4), dtype=np.float32))
    control[2] = 0.0  # a singular pixel
    want = cv.cv_correct(samples, control)
    for eps in (1e-8, 0.5):
        got = cv.cv_correct(samples, control, eps=eps)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------------------------
# the API surface
# --------------------------------------------------------------------------

# JAX keywords the port leaves out on purpose: (module, function, keyword)
# -> why
EXCEPTIONS = {
    **{("ops.pallas.treelet_kernel", fn, "interpret"):
       "Pallas's interpret mode; the port's CPU route is its plain version"
       for fn in ("intersect_bvh_treelet", "occluded_bvh_treelet",
                  "intersect_bvh_treelet_wavefront",
                  "intersect_bvh_treelet_queued")},
    ("tally.tallies", "PhotonTallies.zeros", "dtype"):
        "the port counts in exact int64 and sums the exit tables in float64 "
        "(tally/tallies.py:7), whatever dtype JAX's two-word counters take",
    ("transport.photon", "PhotonState.dead", "dtype"):
        "the port's photon state is float32 (JAX's default), the type K1 "
        "and the superstep engine read",
}
# a JAX PRNG key becomes an int seed or a torch.Generator in the port, in
# the key's place
RENAMES = {"key": ("seed", "gen")}


def public_functions(module):
    """{qualified name: function} of the module's own public functions and
    the public static and class methods of its own public classes."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != module.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            for m, f in vars(obj).items():
                if not m.startswith("_") and isinstance(
                        f, (staticmethod, classmethod)):
                    out[f"{name}.{m}"] = getattr(obj, m)
    return out


def module_pairs():
    """(JAX module's name under the package, JAX module, port module) for
    every JAX module with a port module; ``ops/pallas/*`` is ported as
    ``ops/*``."""
    def names(pkg):
        return {m.name[len(pkg.__name__) + 1:] for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")}
    port = names(light_transport_tpu_torch)
    for rel in sorted(names(light_transport_tpu)):
        prel = rel.replace("ops.pallas.", "ops.")
        if prel in port:
            yield (rel, importlib.import_module(f"light_transport_tpu.{rel}"),
                   importlib.import_module(
                       f"light_transport_tpu_torch.{prel}"))


def test_port_accepts_every_jax_keyword():
    """For each JAX module with a port module, every parameter of a public
    function (and of a public class's static and class methods) is a
    parameter of the port function of the same name: the positional ones
    in JAX's order, a key renamed in its place, and a default that is a
    Python scalar or None equal to JAX's.  The only keywords left out are
    EXCEPTIONS, and each of them is still one JAX takes."""
    seen, used, problems = set(), set(), []
    for rel, jmod, tmod in module_pairs():
        port = public_functions(tmod)
        for name, f in public_functions(jmod).items():
            g = port.get(name)
            if g is None:
                continue
            seen.add(name)
            jps = [p for p in inspect.signature(f).parameters.values()
                   if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
            tps = inspect.signature(g).parameters
            positional = [p.name for p in tps.values()
                          if p.kind == p.POSITIONAL_OR_KEYWORD]
            k = 0
            for p in jps:
                if (rel, name, p.name) in EXCEPTIONS:
                    used.add((rel, name, p.name))
                    continue
                want = RENAMES.get(p.name, (p.name,))
                if not any(w in tps for w in want):
                    problems.append(f"{rel}.{name}: no {p.name}")
                    continue
                q = next(tps[w] for w in want if w in tps)
                if p.kind == p.POSITIONAL_OR_KEYWORD:
                    if positional[k:k + 1] != [q.name]:
                        problems.append(f"{rel}.{name}: {p.name} not at "
                                        f"position {k}")
                    k += 1
                scalar = (int, float, str, bool, type(None))
                if p.name == q.name and p.default is not p.empty \
                        and isinstance(p.default, scalar) \
                        and q.default != p.default:
                    problems.append(f"{rel}.{name}: {p.name}={q.default!r}, "
                                    f"JAX {p.default!r}")
    assert not problems, problems
    assert used == set(EXCEPTIONS), set(EXCEPTIONS) - used
    assert {"trace_paths_split", "trace_whitted_queue", "cv_correct",
            "Scene.build"} <= seen, sorted(seen)
