"""Control-variates variance reduction.

The counterpart of ``light_transport_tpu.integrators.control_variates``:
the path tracer records each bounce's BSDF-sampling log-pdf; the score of
a path is the gradient of the summed records with respect to the *logits*
of its BSDF uniforms; per pixel, the zero-variance linear correction
``alpha = -Sigma_cs^T pinv(Sigma_cc)`` is applied to the samples with the
control ``-0.5 * score``.

- ``mode="exact"``: one ``torch.autograd.grad`` of the summed records
  through :func:`path_tracer.trace_paths`, the radiance taken from the same
  forward pass.  The intersector is not differentiated
  (``ops.dispatch`` detaches its rays and hits, as JAX stops gradients
  there), so no kernel needs a backward and the backward pass launches
  none.
- ``mode="fd"``: the reference's central differences, ``±FD_STEP`` on each
  of the ``2 * max_depth`` logit slots, one full trace each under
  ``torch.no_grad()``.

Both run on the scene's device.  The lanes are iid draws from a
``torch.Generator``: the per-pixel covariance solve assumes independent
samples, so the Sobol' sampler is refused (JAX's CLI rule).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators.path_tracer import (
    _generator,
    _pixel_camera_rays,
    camera_rays,
    trace_paths,
)

FD_STEP = 0.01  # the reference's logit perturbation
# the generator index of a CV render's lanes: rng.fold_seed(seed, CV_STREAM)
CV_STREAM = 0

# the BSDF slots lead the uniform rows, so a row is rebuilt by one cat
assert (rng.U_BSDF0, rng.U_BSDF1) == (0, 1)


class CVRender(NamedTuple):
    image_plain: torch.Tensor  # (H, W, 3) plain MC mean
    image_cv: torch.Tensor  # (H, W, 3) CV-corrected
    samples: torch.Tensor  # (H, W, spp, 3) raw radiance samples
    grad_log_pdf: torch.Tensor  # (H, W, spp, 2*max_depth) score values
    log_pdf: torch.Tensor  # (H, W, spp, max_depth)
    singular: torch.Tensor  # (H, W) bool: pixels where the solve was skipped


class PixelDive(NamedTuple):
    """Telemetry of hand-picked pixels (:func:`cv_pixel_dive`)."""

    samples: torch.Tensor  # (P, S, 3) radiance samples
    log_pdf: torch.Tensor  # (P, S, max_depth)
    grad_log_pdf: torch.Tensor  # (P, S, 2*max_depth)
    corrected: torch.Tensor  # (P, S, 3) CV-corrected samples
    pixel_plain: torch.Tensor  # (P, 3) plain means
    pixel_cv: torch.Tensor  # (P, 3) CV-corrected means


def _bsdf_slots(uniforms: torch.Tensor) -> torch.Tensor:
    """The (N, D, 2) BSDF uniforms of a (N, D, NUM_U) tensor."""
    return uniforms[:, :, :2]


def _with_bsdf_logits(uniforms: torch.Tensor, x_logit: torch.Tensor,
                      exact_primal: bool = False) -> torch.Tensor:
    """The uniform tensor with its BSDF slots taken from logits.

    ``exact_primal`` (only at ``x_logit == logit(u_bsdf)``) substitutes
    ``raw + (s - s.detach())``, ``s = sigmoid(x)``: its forward value is
    the raw uniform bitwise, and its gradient flows through the sigmoid,
    so the differentiated trace's radiance is ``trace_paths(uniforms)``'s."""
    u_bsdf = rng.sigmoid(x_logit)
    if exact_primal:
        u_bsdf = _bsdf_slots(uniforms) + (u_bsdf - u_bsdf.detach())
    return torch.cat([u_bsdf, uniforms[:, :, 2:]], dim=-1)


def _logits(uniforms: torch.Tensor) -> torch.Tensor:
    return rng.logit(_bsdf_slots(uniforms))


def _score_layout(g: torch.Tensor) -> torch.Tensor:
    """(N, D, 2) -> (N, 2D): the D u0 slots, then the D u1 slots (the
    reference's ``record_s_set`` order)."""
    return torch.cat([g[:, :, 0], g[:, :, 1]], dim=-1)


def grad_log_pdf_exact(scene, cfg: RenderConfig, origins, directions,
                       uniforms, ray_chunk: Optional[int] = None):
    """``d(sum_b log pdf_b) / d(logit u)`` of every lane by one backward
    pass.  Returns ``(radiance (N, 3), log_pdf (N, D), grad (N, 2D))``,
    none of them attached to a graph."""
    x0 = _logits(uniforms).detach().requires_grad_(True)
    with torch.enable_grad():
        u = _with_bsdf_logits(uniforms, x0, exact_primal=True)
        radiance, rec = trace_paths(scene, cfg, origins, directions, u,
                                    ray_chunk=ray_chunk)
        (grad,) = torch.autograd.grad(rec.log_pdf.sum(), x0)
    return radiance.detach(), rec.log_pdf.detach(), _score_layout(grad)


def grad_log_pdf_fd(scene, cfg: RenderConfig, origins, directions,
                    uniforms, step: float = FD_STEP,
                    ray_chunk: Optional[int] = None):
    """The reference's central-difference score: for each of the ``2D``
    logit slots, the summed log-pdf records of two traces with the slot
    shifted by ``±step``, differenced; then the plain trace's radiance
    and records.  ``4D + 1`` traces."""
    d = cfg.max_depth
    with torch.no_grad():
        x0 = _logits(uniforms)

        def logpdf_sum_with(slot, sign):
            delta = torch.zeros_like(x0)
            delta[:, slot % d, slot // d] = sign * step
            u = _with_bsdf_logits(uniforms, x0 + delta)
            _, rec = trace_paths(scene, cfg, origins, directions, u,
                                 ray_chunk=ray_chunk)
            return rec.log_pdf.sum(dim=-1)

        plus = torch.stack([logpdf_sum_with(s, 1.0) for s in range(2 * d)])
        minus = torch.stack([logpdf_sum_with(s, -1.0)
                             for s in range(2 * d)])
        g = ((plus - minus) / (2.0 * step)).T
        radiance, rec = trace_paths(scene, cfg, origins, directions,
                                    uniforms, ray_chunk=ray_chunk)
    return radiance, rec.log_pdf, g


def pinv_rtol(c: int, dtype=torch.float32) -> float:
    """``jnp.linalg.pinv``'s default cutoff for a (c, c) matrix, ``10 * c *
    eps`` of the largest singular value (``torch.linalg.pinv`` defaults to
    a tenth of it)."""
    return 10.0 * c * torch.finfo(dtype).eps


def cv_correct(samples: torch.Tensor, control: torch.Tensor):
    """Per-pixel zero-variance CV solve, batched over pixels.

    ``samples`` (P, S, 3), ``control`` (P, S, C).  Returns ``(corrected
    (P, S, 3), singular (P,))``: a pixel whose corrected samples are not
    all finite keeps its uncorrected samples and is flagged."""
    sc = torch.cat([samples, control], dim=2)  # (P, S, 3+C)
    x = sc - sc.mean(dim=1, keepdim=True)
    cov = x.transpose(1, 2) @ x  # the 1/S scale cancels inside alpha
    k = samples.shape[2]
    sigma_cs = cov[:, :k, k:]  # (P, 3, C), Sigma_cs^T
    sigma_cc = cov[:, k:, k:]  # (P, C, C)
    c = sigma_cc.shape[-1]
    alpha = -(sigma_cs @ torch.linalg.pinv(
        sigma_cc, rtol=pinv_rtol(c, sigma_cc.dtype)))  # (P, 3, C)
    corrected = samples + (alpha @ control.transpose(1, 2)).transpose(1, 2)
    bad = ~torch.isfinite(corrected).all(dim=2).all(dim=1)
    return torch.where(bad[:, None, None], samples, corrected), bad


def _check_cv(cfg: RenderConfig, mode: str):
    if mode not in ("exact", "fd"):
        raise ValueError(f"unknown CV mode: {mode}")
    if cfg.sampler != "uniform":
        raise ValueError(
            f"sampler={cfg.sampler!r}: the CV solve needs iid samples "
            "(render_cv draws from a generator)")


def _cv_lane_uniforms(scene, cfg: RenderConfig, seed: int, n: int):
    """The CV lanes' draws from the generator of ``rng.fold_seed(seed,
    CV_STREAM)``, in JAX's order: the (n, 2) jitter, the path uniforms,
    then, only when ``cfg.aperture > 0``, the (n, 2) lens points.  For a
    full frame these are ``render_image(scene, cfg, rng.fold_seed(seed,
    CV_STREAM))``'s draws.  The lens points are not differentiated or
    perturbed."""
    dt = scene.camera.dtype
    gen = _generator(scene, rng.fold_seed(seed, CV_STREAM))
    u_aa = torch.rand((n, 2), generator=gen, dtype=dt, device=gen.device)
    uniforms = rng.path_uniforms(gen, n, cfg.max_depth, dtype=dt)
    u_lens = None
    if cfg.aperture > 0.0:
        u_lens = torch.rand((n, 2), generator=gen, dtype=dt,
                            device=gen.device)
    return u_aa, uniforms, u_lens


def _score(scene, cfg, origins, directions, uniforms, mode, ray_chunk):
    fn = grad_log_pdf_exact if mode == "exact" else grad_log_pdf_fd
    return fn(scene, cfg, origins, directions, uniforms,
              ray_chunk=ray_chunk)


def cv_pixel_dive(scene, cfg: RenderConfig, seed: int, pixels,
                  n_samples: int = 500, mode: str = "exact",
                  ray_chunk: Optional[int] = None) -> PixelDive:
    """``n_samples`` fresh paths through each selected ``(row, col)`` pixel
    with the full CV telemetry (the reference's extra pass at hand-picked
    pixels)."""
    _check_cv(cfg, mode)
    pix = np.asarray(pixels, np.int64).reshape(-1, 2)
    p = pix.shape[0]
    pixel_ids = torch.as_tensor(
        np.repeat(pix[:, 0] * cfg.width + pix[:, 1], n_samples),
        device=scene.device)
    u_aa, uniforms, u_lens = _cv_lane_uniforms(scene, cfg, seed,
                                               p * n_samples)
    origins, directions = _pixel_camera_rays(scene, cfg, pixel_ids, u_aa,
                                             u_lens)
    radiance, log_pdf, g = _score(scene, cfg, origins, directions, uniforms,
                                  mode, ray_chunk)
    samples = radiance.reshape(p, n_samples, 3)
    g = g.reshape(p, n_samples, -1)
    corrected, _ = cv_correct(samples, -0.5 * g)
    return PixelDive(samples=samples,
                     log_pdf=log_pdf.reshape(p, n_samples, -1),
                     grad_log_pdf=g, corrected=corrected,
                     pixel_plain=samples.mean(dim=1),
                     pixel_cv=corrected.mean(dim=1))


def render_cv(scene, cfg: RenderConfig, seed: int = 0, mode: str = "exact",
              ray_chunk: Optional[int] = None) -> CVRender:
    """The CV render on the scene's device: the plain image, the
    CV-corrected image and the telemetry (the reference's image_ver1 and
    image_ver2).  ``mode``: ``"exact"`` or ``"fd"``."""
    _check_cv(cfg, mode)
    hw = (cfg.height, cfg.width)
    n = cfg.height * cfg.width * cfg.spp
    u_aa, uniforms, u_lens = _cv_lane_uniforms(scene, cfg, seed, n)
    origins, directions = camera_rays(scene, cfg, u_aa, u_lens)
    radiance, log_pdf, g = _score(scene, cfg, origins, directions, uniforms,
                                  mode, ray_chunk)

    def to_pix(x):
        # lanes are spp-major: (spp, H*W, ...) -> (H*W, spp, ...)
        return x.reshape((cfg.spp, n // cfg.spp) + x.shape[1:]).transpose(
            0, 1)

    samples = to_pix(radiance)
    corrected, singular = cv_correct(samples, -0.5 * to_pix(g))
    return CVRender(
        image_plain=torch.clamp(samples.mean(dim=1), 0, 1).reshape(hw + (3,)),
        image_cv=torch.clamp(corrected.mean(dim=1), 0, 1).reshape(hw + (3,)),
        samples=samples.reshape(hw + (cfg.spp, 3)),
        grad_log_pdf=to_pix(g).reshape(hw + (cfg.spp, 2 * cfg.max_depth)),
        log_pdf=to_pix(log_pdf).reshape(hw + (cfg.spp, cfg.max_depth)),
        singular=singular.reshape(hw))
