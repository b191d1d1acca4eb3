"""The port's adaptive integrator (``integrators/adaptive.py``,
``api.render(integrator="adaptive")``) on the CPU: ``_integer_alloc``
against JAX's on the same weights, the exact budget and the exploration
of every pixel, the refusals and the API's round rule, a round with no
host readback, and a Sobol' adaptive render against JAX's
``render_adaptive`` from the same seed bits.

JAX's rounds run through a fresh ``jax.jit`` of its ``_round`` at the
tests' ``CHEAP_COMPILE``, with ``jax.random.bits`` handing it the port's
seed bits.  Tolerances: allocations sum exactly, >= 99 % of entries
equal and the rest off by at most 1 (the two packages may sum float32
weights in different orders); the Sobol' render's count maps equal, and
>= 99 % of pixels within 1e-4.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.integrators import adaptive as jad
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu_torch import api
from light_transport_tpu_torch.integrators import adaptive as ad
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.ops import qmc
from light_transport_tpu_torch.utils import interop
from test_torch_render import CHEAP_COMPILE, jax_scene_arrays, port_cfg

torch.set_num_threads(1)


def test_integer_alloc_matches_jax():
    for seed in range(5):
        r = np.random.default_rng(seed)
        w = (r.random(97) * r.integers(1, 4, 97)).astype(np.float32)
        w[r.random(97) < 0.1] = 0.0
        got = ad._integer_alloc(torch.from_numpy(w), 1234).numpy()
        want = np.asarray(jad._integer_alloc(jnp.asarray(w), 1234))
        assert got.sum() == 1234 and (got >= 0).all()
        assert (got == want).mean() >= 0.99
        assert np.abs(got.astype(int) - want).max() <= 1
    a = ad._integer_alloc(torch.zeros(10), 100)
    assert int(a.sum()) == 100 and bool((a >= 0).all())
    assert a.dtype == torch.int32
    # the targets 0.5, 1, 1.5, 2 round half to even (0, 1, 2, 2), as
    # jnp.round does
    half = ad._integer_alloc(torch.ones(4), 2).numpy()
    np.testing.assert_array_equal(half, [0, 1, 1, 0])
    np.testing.assert_array_equal(
        half, np.asarray(jad._integer_alloc(jnp.ones(4), 2)))


def test_budget_exact_and_explores_every_pixel():
    scene, cfg = presets.lts_scene(width=12, height=12, spp=8, max_depth=2,
                                   device="cpu")
    img, counts = ad.render_adaptive(scene, cfg, seed=0, rounds=4,
                                     return_counts=True)
    assert int(counts.sum()) == 12 * 12 * 8
    assert int(counts.min()) >= 8 // 4
    assert int(counts.max()) > 8
    assert img.shape == (12, 12, 3) and torch.isfinite(img).all()
    assert torch.equal(img, ad.render_adaptive(scene, cfg, seed=0))


def test_refusals_and_the_round_rule():
    scene, cfg = presets.lts_scene(width=4, height=4, spp=10, max_depth=1,
                                   device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        ad.render_adaptive(scene, cfg, rounds=4)
    split = dataclasses.replace(cfg, spp=4, fresnel_mode="split")
    with pytest.raises(ValueError, match="stochastic"):
        api.render(scene, split, integrator="adaptive")
    # the adaptive rounds ignore compact_tail, as JAX's do
    c = dataclasses.replace(cfg, spp=8)
    assert torch.equal(
        api.render(scene, dataclasses.replace(c, compact_tail=True),
                   seed=1, integrator="adaptive"),
        api.render(scene, c, seed=1, integrator="adaptive"))
    # rounds: the largest of 4, 3, 2 and 1 that divides spp
    for spp, rounds in ((8, 4), (6, 3), (10, 2), (7, 1)):
        c = dataclasses.replace(cfg, spp=spp)
        assert torch.equal(api.render(scene, c, seed=1,
                                      integrator="adaptive"),
                           ad.render_adaptive(scene, c, 1, rounds=rounds))


def test_round_reads_nothing_back():
    """No Python ``if`` on a tensor in a round: ``bool``, ``item`` and
    ``tolist`` on a tensor raise inside it, for both samplers and the
    lens."""
    scene, cfg = presets.lts_scene(width=6, height=5, spp=4, max_depth=2,
                                   device="cpu")

    def refuse(*a, **k):
        raise AssertionError("a round read a tensor back")

    for c in (cfg, dataclasses.replace(cfg, sampler="sobol", aperture=0.1)):
        n = 30
        stats = (torch.zeros(n, 3), torch.zeros(n), torch.zeros(n),
                 torch.zeros(n, dtype=torch.int32))
        with mock.patch.object(torch.Tensor, "__bool__", refuse), \
                mock.patch.object(torch.Tensor, "item", refuse), \
                mock.patch.object(torch.Tensor, "tolist", refuse):
            for r in range(2):
                stats, alloc = ad._round(scene, c, 3, n, stats, r)
        assert int(stats[3].sum()) == 2 * n and int(alloc.sum()) == n


def test_uniform_rounds_draw_from_fold_seed():
    """Round ``r`` of the uniform sampler draws its jitter, path uniforms
    and lens points, in that order, from ``fold_seed(seed, r)``."""
    from light_transport_tpu_torch.core import rng
    from light_transport_tpu_torch.integrators import path_tracer as pt

    scene, cfg = presets.lts_scene(width=5, height=4, spp=2, max_depth=2,
                                   device="cpu")
    cfg = dataclasses.replace(cfg, aperture=0.1)
    seen, trace = [], pt.trace_paths

    def spy(scene, cfg, o, d, u, ray_chunk=None):
        seen.append((o, d, u))
        return trace(scene, cfg, o, d, u, ray_chunk=ray_chunk)

    with mock.patch.object(pt, "trace_paths", spy):
        ad.render_adaptive(scene, cfg, seed=9, rounds=2)
    n = 20
    for r, (o, d, u) in enumerate(seen):
        gen = torch.Generator().manual_seed(rng.fold_seed(9, r))
        u_aa = torch.rand((n, 2), generator=gen)
        assert torch.equal(u, rng.path_uniforms(gen, n, 2))
        u_lens = torch.rand((n, 2), generator=gen)
        pixel = torch.arange(n)  # round 0 is uniform: one lane a pixel
        if r == 0:
            want = pt._pixel_camera_rays(scene, cfg, pixel, u_aa, u_lens)
            assert torch.equal(o, want[0]) and torch.equal(d, want[1])
    assert len(seen) == 2 and not torch.equal(seen[0][2], seen[1][2])


def jax_render_adaptive(js, jcfg, bits, rounds):
    """JAX's ``render_adaptive`` with its seed bits set to ``bits``."""
    fresh = jax.jit(jad._round.__wrapped__, static_argnums=(1, 3, 6),
                    compiler_options=CHEAP_COMPILE)
    with mock.patch.object(jad, "_round", fresh), \
            mock.patch.object(jax.random, "bits",
                              lambda key, *a, **k: jnp.uint32(bits)):
        img, counts = jad.render_adaptive(js, jcfg, jax.random.key(0),
                                          rounds=rounds, return_counts=True)
    return np.asarray(img), np.asarray(counts)


def test_sobol_adaptive_matches_jax():
    """Sobol' rounds with the thin lens: each pixel's sequence resumes at
    its count."""
    js, jcfg = jpresets.lts_scene(width=12, height=10, spp=8, max_depth=2)
    jcfg = dataclasses.replace(jcfg, sampler="sobol", aperture=0.15)
    scene = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    cfg = port_cfg(jcfg)
    jimg, jcounts = jax_render_adaptive(js, jcfg, qmc.seed_bits(7), 4)
    img, counts = ad.render_adaptive(scene, cfg, 7, rounds=4,
                                     return_counts=True)
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    close = (np.abs(img.numpy() - jimg) <= 1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert int(counts.max()) > 8 and float(img.mean()) > 0.05
    assert torch.equal(img, api.render(scene, cfg, seed=7,
                                       integrator="adaptive"))
