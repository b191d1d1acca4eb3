"""The port's Sobol' sampler (``ops.qmc``) and thin lens on the CPU:
``sobol2d``, ``owen_scramble``, ``scrambled_pair``, ``lane_uniforms`` and
``render_uniforms`` bitwise JAX's uint32 for the same seed bits; the
thin-lens camera rays against JAX's ``_pixel_camera_rays``; a Sobol' and
lens render of the LTS Cornell box against JAX's from the same seed bits;
the progressive Sobol' passes against the one-shot render;
``render_sharded`` with both bitwise ``render_image`` on a CPU mesh; and
the pinhole uniform stream, unchanged.

JAX's integer build runs eagerly (integer ops round nothing, so jit
changes no bit); its camera and tracer compiled with the tests'
``CHEAP_COMPILE``.  Tolerances: the point sets bitwise; camera rays
within rtol 1e-6 (XLA fuses the lens's multiply-adds); rendered pixels
within 1e-4 on >= 99 %.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.ops import qmc as jqmc
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.ops import qmc
from light_transport_tpu_torch.parallel import mesh as pm
from light_transport_tpu_torch.utils import interop
from test_torch_render import CHEAP_COMPILE, jax_scene_arrays, port_cfg

torch.set_num_threads(1)

PINHOLE = (pathlib.Path(__file__).parent / "golden"
           / "torch_pinhole_lts_8x6.npy")
BITS = (0, 7, 0xDEADBEEF, qmc.seed_bits(3))


def u64(a):
    return np.asarray(a).astype(np.int64)


def test_sobol2d_and_scrambles_bitwise():
    x, y = qmc.sobol2d(torch.arange(8))
    pts = torch.stack([x, y], -1).numpy() / 2 ** 32
    want = np.array([[0, 0], [4, 4], [2, 6], [6, 2], [1, 5], [5, 1], [3, 3],
                     [7, 7]]) / 8.0
    np.testing.assert_array_equal(pts, want)
    r = np.random.default_rng(0)
    idx = r.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    seed = r.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    tx, ts = torch.from_numpy(u64(idx)), torch.from_numpy(u64(seed))
    jx, jy = jqmc.sobol2d(idx)
    px, py = qmc.sobol2d(tx)
    assert np.array_equal(u64(jx), px.numpy())
    assert np.array_equal(u64(jy), py.numpy())
    assert np.array_equal(u64(jqmc.owen_scramble(idx, seed)),
                          qmc.owen_scramble(tx, ts).numpy())
    assert np.array_equal(u64(jqmc._mix(idx)), qmc._mix(tx).numpy())
    assert np.array_equal(u64(jqmc._hash(idx, 5, np.uint32(0xDEADBEEF), 2)),
                          qmc._hash(tx, 5, 0xDEADBEEF, 2).numpy())
    # the 16-bit split multiply is the wrapped uint32 product
    c = 0x846CA68B
    assert np.array_equal(u64(idx * np.uint32(c)), qmc._mul(tx, c).numpy())


def test_scrambled_pair_and_lane_uniforms_bitwise():
    for bits in BITS:
        r = np.random.default_rng(bits & 0xFFFF)
        pix = r.integers(0, 10_000, 300).astype(np.int32)
        smp = r.integers(0, 1 << 20, 300).astype(np.int32)
        tp, ts = torch.from_numpy(pix), torch.from_numpy(smp)
        for pair in (0, 3, jqmc.LENS_PAIR):
            jx, jy = jqmc.scrambled_pair(pix, smp, pair, np.uint32(bits))
            x, y = qmc.scrambled_pair(tp, ts, pair, bits)
            assert np.array_equal(np.asarray(jx), x.numpy())
            assert np.array_equal(np.asarray(jy), y.numpy())
        ja, ju = jqmc.lane_uniforms(np.uint32(bits), jnp.asarray(pix),
                                    jnp.asarray(smp), 3)
        a, u = qmc.lane_uniforms(bits, tp, ts, 3)
        assert a.shape == (300, 2) and u.shape == (300, 3, rng.NUM_U)
        assert np.array_equal(np.asarray(ja), a.numpy())
        assert np.array_equal(np.asarray(ju), u.numpy())


def test_render_uniforms_bitwise():
    """The s-major render layout (hashes once a pixel, broadcast over the
    samples) and the lens pair, at sample offsets 0 and 5."""
    bits = qmc.seed_bits(11)
    h, w, spp = 3, 5, 4
    for offset in (0, 5):
        ja, ju = jqmc.render_uniforms(
            np.uint32(bits), h, w, spp, 2,
            sample_offset=jnp.asarray(offset, jnp.int32))
        a, u = qmc.render_uniforms(bits, h, w, spp, 2, sample_offset=offset,
                                   device="cpu")
        assert np.array_equal(np.asarray(ja), a.numpy())
        assert np.array_equal(np.asarray(ju), u.numpy())
        assert 0.0 < float(u.min()) and float(u.max()) < 1.0
        pix = np.tile(np.arange(h * w, dtype=np.int32), spp)
        smp = np.repeat(offset + np.arange(spp, dtype=np.int32), h * w)
        lx, ly = jqmc.scrambled_pair(pix, smp, jqmc.LENS_PAIR,
                                     np.uint32(bits))
        lens = qmc.render_pair(bits, h, w, spp, qmc.LENS_PAIR,
                               sample_offset=offset, device="cpu")
        assert np.array_equal(np.stack([lx, ly], -1), lens.numpy())
    assert qmc.seed_bits(11) == rng.fold_seed(11, qmc.SEED_TAG) & 0xFFFFFFFF
    assert qmc.seed_bits(11) != qmc.seed_bits(12)


@pytest.fixture(scope="module")
def cornell():
    js, jcfg = jpresets.lts_scene(width=16, height=16, spp=2, max_depth=3)
    jcfg = dataclasses.replace(jcfg, sampler="sobol", aperture=0.1)
    scene = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    return js, jcfg, scene, port_cfg(jcfg)


def jax_lanes(js, jcfg, bits):
    """JAX's ``_camera_lanes`` for the Sobol' sampler with the seed bits
    handed in (JAX draws them from its key)."""
    n_pix = jcfg.height * jcfg.width
    u_aa, uni = jqmc.render_uniforms(np.uint32(bits), jcfg.height,
                                     jcfg.width, jcfg.spp, jcfg.max_depth)
    pix = np.tile(np.arange(n_pix, dtype=np.int32), jcfg.spp)
    smp = np.repeat(np.arange(jcfg.spp, dtype=np.int32), n_pix)
    lx, ly = jqmc.scrambled_pair(pix, smp, jqmc.LENS_PAIR, np.uint32(bits))
    return u_aa, uni, np.stack([lx, ly], -1)


def test_thin_lens_camera_rays(cornell):
    """At the screen plane's focus (``focus_distance=0``) and at 4.0."""
    js, jcfg, scene, cfg = cornell
    u_aa, _, u_lens = jax_lanes(js, jcfg, qmc.seed_bits(1))
    for focus in (0.0, 4.0):
        jc = dataclasses.replace(jcfg, focus_distance=focus)
        c = dataclasses.replace(cfg, focus_distance=focus)
        jo, jd = jax.jit(lambda a, b: jpt.camera_rays(js, jc, a, b),
                         compiler_options=CHEAP_COMPILE)(u_aa, u_lens)
        o, d, _ = pt._camera_lanes(scene, c, 1)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-7)
        # the lens moves the origins in the camera's xy plane, by at most
        # the aperture
        off = o.numpy() - scene.camera.numpy()
        assert np.abs(off[:, 2]).max() == 0.0
        r = np.linalg.norm(off[:, :2], axis=1)
        assert r.max() <= c.aperture + 1e-6 and r.mean() > 0.02


def test_sobol_lens_render_matches_jax(cornell):
    js, jcfg, scene, cfg = cornell
    u_aa, uni, u_lens = jax_lanes(js, jcfg, qmc.seed_bits(2))
    jimg = np.asarray(jax.jit(lambda a, u, l: jpt._to_image(jpt.trace_paths(
        js, jcfg, *jpt.camera_rays(js, jcfg, a, l), u)[0], jcfg)[0],
        compiler_options=CHEAP_COMPILE)(u_aa, uni, u_lens))
    img = pt.render_image(scene, cfg, seed=2).numpy()
    close = (np.abs(img - jimg) <= 1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert img.mean() > 0.05


def test_progressive_sobol_continues_one_point_set(cornell):
    """Two spp-2 passes at offsets 0 and 2 trace exactly the spp-4
    render's samples; ``render_progressive`` averages the two clipped
    pass images (``tests/test_qmc.py:123-140``)."""
    _, _, scene, cfg = cornell
    c4 = dataclasses.replace(cfg, spp=4)
    _, s0 = pt.render_image(scene, cfg, 6, return_samples=True)
    _, s1 = pt.render_image(scene, cfg, 6, return_samples=True,
                            sample_offset=2)
    _, s4 = pt.render_image(scene, c4, 6, return_samples=True)
    assert torch.equal(torch.cat([s0, s1], dim=2), s4)
    prog = pt.render_progressive(scene, cfg, seed=6, n_passes=2)
    want = (torch.clamp(s0.mean(dim=2), 0, 1)
            + torch.clamp(s1.mean(dim=2), 0, 1)) / 2
    assert torch.equal(prog, want)
    one = pt.render_image(scene, c4, 6)
    assert float((prog - one).abs().max()) < 0.5
    assert float((prog - one).abs().mean()) < 0.05


def test_render_sharded_sobol_lens_bitwise(cornell):
    """Sharded renders build their lanes through ``_camera_lanes``, so the
    Sobol' points and the lens reach every shard."""
    _, _, scene, cfg = cornell
    cfg = dataclasses.replace(cfg, width=6, height=5, spp=2)
    want = pt.render_image(scene, cfg, seed=4)
    for n in (1, 3):
        got = pm.render_sharded(scene, cfg, seed=4,
                                mesh=pm.make_mesh(n, device_type="cpu"))
        assert torch.equal(got, want), n


def test_pinhole_uniform_stream_unchanged():
    """``aperture == 0`` keeps the port's draw order (jitter, then the path
    uniforms): a pinhole render of this tree equals the same render from
    before the lens and the Sobol' sampler, bitwise; the lens's points
    are drawn last."""
    scene, cfg = presets.lts_scene(width=8, height=6, spp=2, max_depth=3,
                                   device="cpu")
    img = pt.render_image(scene, cfg, seed=5)
    assert np.array_equal(img.numpy(), np.load(PINHOLE))
    n = 8 * 6 * 2
    gen = torch.Generator().manual_seed(5)
    u_aa = torch.rand((n, 2), generator=gen)
    uni = rng.path_uniforms(gen, n, 3)
    u_lens = torch.rand((n, 2), generator=gen)
    o, d, u = pt._camera_lanes(scene, cfg, 5)
    assert torch.equal(u, uni)
    assert torch.equal(d, pt.camera_rays(scene, cfg, u_aa)[1])
    lens = dataclasses.replace(cfg, aperture=0.2)
    ol, dl, ul = pt._camera_lanes(scene, lens, 5)
    assert torch.equal(ul, uni)
    want = pt.camera_rays(scene, lens, u_aa, u_lens)
    assert torch.equal(ol, want[0]) and torch.equal(dl, want[1])
