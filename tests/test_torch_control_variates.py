"""The port's control variates against the JAX package on the CPU: the
dispatch stopping gradients at the intersector, ``logit`` and
``sigmoid``, the exact score from the same uniforms, the port's exact
score against its own finite differences, the per-pixel solve with JAX's
pseudo-inverse cutoff, and ``render_cv`` end to end.

The JAX score is computed once, compiled with the tests' ``CHEAP_COMPILE``
options.  Tolerances: the score within 2.1e-5 of JAX's (JAX's own spread
between its eager and jitted scores on this input), the radiance and the
log-pdf records within rtol 1e-4, atol 1e-5; ``logit`` and ``sigmoid``
within rtol 1e-6 (``logit`` also atol 1.2e-7, two ulps of its logs, where
they cancel); the solve within rtol 1e-3,
atol 1e-4 (float32 sums of products over 64 samples and a small SVD on
each side); exact against fd as ``tests/test_control_variates.py:31-44``
holds them (>= 90 % of slots within 5e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.core import rng as jrng
from light_transport_tpu.integrators import control_variates as jcv
from light_transport_tpu.integrators.path_tracer import camera_rays as jcam
from light_transport_tpu.scene.cornell import cornell_box_scene as jcornell
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.integrators import control_variates as cv
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.ops import dispatch
from light_transport_tpu_torch.scene.cornell import cornell_box_scene
from light_transport_tpu_torch.tally.stats import image_mae
from light_transport_tpu_torch.utils import interop
from test_torch_render import CHEAP_COMPILE, jax_scene_arrays, port_cfg

torch.set_num_threads(1)

SCORE_ATOL = 2.1e-5  # JAX's eager against jitted spread on this input


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def cornell():
    """Cornell 6x6x2 at depth 3 on both sides, uniforms made by numpy,
    and JAX's exact score from them."""
    js, jcfg = jcornell(width=6, height=6, spp=2, max_depth=3)
    n = 72
    r = np.random.default_rng(14)
    u_aa = r.random((n, 2), dtype=np.float32)
    uni = np.maximum(r.random((n, 3, 7), dtype=np.float32),
                     np.finfo(np.float32).tiny)
    o, d = jcam(js, jcfg, jnp.asarray(u_aa))
    score = jax.jit(
        lambda s, o, d, u: jcv.grad_log_pdf_exact(s, jcfg, o, d, u),
        compiler_options=CHEAP_COMPILE)
    want = [np.asarray(x) for x in score(js, o, d, jnp.asarray(uni))]
    scene = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    return dict(scene=scene, cfg=port_cfg(jcfg), o=t(o), d=t(d), u=t(uni),
                want=want)


def test_dispatch_stops_gradients():
    """A direction that requires a gradient goes through the brute force:
    the hit distance, the occlusion and the transmittance carry none, and
    the forward results equal the undifferentiated ones."""
    scene, cfg = cornell_box_scene(width=4, height=4, spp=1, max_depth=1,
                                   device="cpu")
    o, d = pt.camera_rays(scene, cfg,
                          torch.full((16, 2), 0.5, dtype=torch.float32))
    leaf = d.clone().requires_grad_(True)
    hit = dispatch.scene_intersect(scene, o, leaf)
    assert not hit.t.requires_grad
    assert torch.equal(hit.t, dispatch.scene_intersect(scene, o, d).t)
    dist = torch.full((16,), 3.0) * leaf[:, 2].abs()
    assert not dispatch.scene_occluded(scene, o, leaf, dist).requires_grad
    tr = dispatch.scene_transmittance(scene, o, leaf, dist)
    assert not tr.requires_grad
    assert torch.equal(tr, dispatch.scene_transmittance(scene, o, d,
                                                        dist.detach()))


def test_logit_and_sigmoid_match_jax():
    r = np.random.default_rng(3)
    u = np.concatenate([r.random(4096, dtype=np.float32),
                        np.asarray([np.finfo(np.float32).tiny, 0.5,
                                    1.0 - 2.0 ** -24], np.float32)])
    x = np.asarray(jrng.logit(jnp.asarray(u)))
    # log(u) - log1p(-u) cancels near u = 1/2: two ulps of the logs
    np.testing.assert_allclose(rng.logit(t(u)).numpy(), x, rtol=1e-6,
                               atol=1.2e-7)
    xs = np.linspace(-30, 30, 4097, dtype=np.float32)
    np.testing.assert_allclose(rng.sigmoid(t(xs)).numpy(),
                               np.asarray(jrng.sigmoid(jnp.asarray(xs))),
                               rtol=1e-6, atol=1e-30)
    back = rng.sigmoid(rng.logit(t(u[:4096])))
    np.testing.assert_allclose(back.numpy(), u[:4096], rtol=1e-5)


def test_grad_log_pdf_exact_matches_jax(cornell):
    c = cornell
    rad, log_pdf, g = cv.grad_log_pdf_exact(c["scene"], c["cfg"], c["o"],
                                            c["d"], c["u"])
    want_rad, want_lp, want_g = c["want"]
    assert g.shape == (72, 6) and not g.requires_grad
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(log_pdf.numpy(), want_lp, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(rad.numpy(), want_rad, rtol=1e-4, atol=1e-5)
    # the differentiated trace's radiance is the plain trace's, bitwise
    plain, rec = pt.trace_paths(c["scene"], c["cfg"], c["o"], c["d"], c["u"])
    assert torch.equal(rad, plain) and torch.equal(log_pdf, rec.log_pdf)
    # a bounce's pdf depends on its own uniforms: lanes that shaded at
    # bounce 0 score in slot 0 or slot D (tests/test_control_variates.py)
    lane = log_pdf[:, 0] != 0.0
    nz = (g[lane, 0].abs() > 1e-7) | (g[lane, 3].abs() > 1e-7)
    assert lane.sum() > 0 and nz.double().mean() > 0.95


def test_exact_matches_fd_in_the_port(cornell):
    c = cornell
    r1, lp1, ge = cv.grad_log_pdf_exact(c["scene"], c["cfg"], c["o"],
                                        c["d"], c["u"])
    r2, lp2, gf = cv.grad_log_pdf_fd(c["scene"], c["cfg"], c["o"], c["d"],
                                     c["u"], step=1e-3)
    assert torch.equal(r1, r2) and torch.equal(lp1, lp2)
    close = torch.isclose(ge, gf, rtol=5e-2, atol=5e-2)
    assert close.double().mean() > 0.9, close.double().mean()


def solve_inputs():
    """(P, S, 3 + C) inputs, C = 4: pixel 0's control is zero (a singular
    covariance), pixel 1's covariance has singular values of relative
    size ~1e-6, between torch's default cutoff (C eps = 4.8e-7) and
    JAX's (10 C eps = 4.8e-6), pixel 2 holds a NaN sample (flagged), the
    rest correlate with their control."""
    r = np.random.default_rng(5)
    p, s, c = 12, 64, 4
    control = r.standard_normal((p, s, c)).astype(np.float32)
    control[0] = 0.0
    control[1, :, 1] = 1e-3 * r.standard_normal(s)
    control[1, :, 2:] = 0.0
    beta = np.asarray([[1.0, -2.0, 0.5, 0.0], [0.0, 1.0, 1.0, -1.0],
                       [2.0, 0.0, 0.0, 1.0]], np.float32)
    samples = (5.0 + np.einsum("psc,rc->psr", control, beta)
               + 0.1 * r.standard_normal((p, s, 3))).astype(np.float32)
    samples[2, 7, 1] = np.nan
    return samples, control


def test_cv_correct_matches_jax_with_its_cutoff():
    samples, control = solve_inputs()
    want, want_bad = jcv.cv_correct(jnp.asarray(samples),
                                    jnp.asarray(control))
    got, bad = cv.cv_correct(t(samples), t(control))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(want_bad))
    assert bad.tolist() == [False, False, True] + [False] * 9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)
    # the singular pixel and the flagged one keep their samples
    assert torch.equal(got[0], t(samples[0]))
    assert torch.equal(got[2].nan_to_num(), t(samples[2]).nan_to_num())
    # torch's default cutoff keeps pixel 1's small singular value, and its
    # solve is then another one
    x = torch.cat([t(samples[1]), t(control[1])], dim=1)
    x = x - x.mean(dim=0)
    cov = x.T @ x
    sv = torch.linalg.svdvals(cov[3:, 3:])
    assert 4.8e-7 < float(sv[1] / sv[0]) < 4.8e-6, sv
    alpha = -(cov[:3, 3:] @ torch.linalg.pinv(cov[3:, 3:]))
    other = t(samples[1]) + (alpha @ t(control[1]).T).T
    assert float((other - got[1]).abs().max()) > 1e-2


def test_render_cv_end_to_end():
    scene, cfg = cornell_box_scene(width=10, height=10, spp=16, max_depth=3,
                                   device="cpu")
    out = cv.render_cv(scene, cfg, seed=2)
    for img in (out.image_plain, out.image_cv):
        assert img.shape == (10, 10, 3) and torch.isfinite(img).all()
        assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    assert image_mae(out.image_plain, out.image_cv) < 0.15
    assert out.grad_log_pdf.shape == (10, 10, 16, 6)
    assert out.log_pdf.shape == (10, 10, 16, 3)
    assert out.samples.shape == (10, 10, 16, 3)
    assert out.singular.shape == (10, 10) and not out.singular.any()
    # the plain image is the path tracer's from the same draws
    seed = rng.fold_seed(2, cv.CV_STREAM)
    img, samples = pt.render_image(scene, cfg, seed, return_samples=True)
    assert torch.equal(out.image_plain, img)
    assert torch.equal(out.samples, samples)
    # the control has zero mean: the two estimators agree on average
    assert float(out.image_cv.mean()) == pytest.approx(
        float(out.image_plain.mean()), abs=0.05)


def test_fd_mode_pixel_dive_and_refusals():
    scene, cfg = cornell_box_scene(width=6, height=6, spp=4, max_depth=2,
                                   device="cpu")
    ex = cv.render_cv(scene, cfg, seed=1)
    fd = cv.render_cv(scene, cfg, seed=1, mode="fd")
    assert torch.equal(ex.samples, fd.samples)
    assert torch.isfinite(fd.image_cv).all()
    close = torch.isclose(ex.grad_log_pdf, fd.grad_log_pdf, rtol=5e-2,
                          atol=5e-2)
    assert close.double().mean() > 0.9
    dive = cv.cv_pixel_dive(scene, cfg, 4, pixels=[(1, 2), (4, 3)],
                            n_samples=32)
    assert dive.samples.shape == (2, 32, 3)
    assert dive.grad_log_pdf.shape == (2, 32, 4)
    assert torch.isfinite(dive.pixel_cv).all()
    # the dive's lanes are the render's pixels' rays with the dive's draws
    u_aa, uni, _ = cv._cv_lane_uniforms(scene, cfg, 4, 64)
    ids = torch.tensor([1 * 6 + 2] * 32 + [4 * 6 + 3] * 32)
    o, d = pt._pixel_camera_rays(scene, cfg, ids, u_aa)
    rad, _ = pt.trace_paths(scene, cfg, o, d, uni)
    assert torch.equal(dive.samples.reshape(-1, 3), rad)
    with pytest.raises(ValueError, match="unknown CV mode"):
        cv.render_cv(scene, cfg, mode="exactly")
    with pytest.raises(ValueError, match="iid"):
        cv.render_cv(scene, dataclasses.replace(cfg, sampler="sobol"))
