"""Adaptive sampling: the render's budget of ``H * W * spp`` paths spent
over rounds, each round's lanes allocated to the pixels whose estimates
are still noisy.

The counterpart of ``light_transport_tpu.integrators.adaptive``.  Every
round traces the same lane count ``B = H * W * spp / rounds``; a lane's
pixel comes from the allocation's prefix sum by ``torch.searchsorted``,
and the allocation from a rounded cumulative target, so each round's
lanes sum to exactly ``B``.  A round reads nothing back to the host: the
guards on all-zero weights are ``torch.where``.

With ``sampler="uniform"`` round ``r`` draws from a generator seeded with
``core.rng.fold_seed(seed, r)``, and each pixel mean is unbiased (the
allocation depends on earlier rounds only).  With ``sampler="sobol"``
each pixel owns one sequence and a round resumes it at the pixel's count
(``ops.qmc.lane_uniforms``); the estimate stays consistent.

The results of a round are added to the pixels by ``index_add_``: on the
card its float adds land in the card's order, so the card's image is held
within a tolerance of the CPU's, not bitwise.
"""

from __future__ import annotations

from typing import Optional

import torch

from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.ops import qmc

# the share of each round allocated uniformly: pixels whose variance
# estimate is still zero keep receiving samples
_EXPLORE = 0.25


def _integer_alloc(weights: torch.Tensor, budget: int) -> torch.Tensor:
    """A nonnegative int32 allocation that sums to ``budget`` exactly,
    proportional to ``weights`` (rounded cumulative targets, differenced;
    ``torch.round`` rounds half to even, as ``jnp.round``)."""
    w = torch.clamp(weights, min=0.0)
    # all-zero weights spend the budget uniformly
    w = torch.where(w.sum() > 0, w, torch.ones_like(w))
    c = torch.cumsum(w, dim=0)
    total = torch.clamp(c[-1], min=1e-30)
    targets = torch.round(c / total * budget).to(torch.int32)
    return torch.diff(targets, prepend=torch.zeros_like(targets[:1]))


def _round(scene, cfg: RenderConfig, seed: int, budget: int, stats,
           round_idx: int, ray_chunk: Optional[int] = None):
    """One round: allocate ``budget`` lanes from the running ``stats`` =
    (sum_rgb (P, 3), sum_l (P,), sum_l2 (P,), count (P,) int32), trace
    them, and add their results to ``stats`` in place.  Returns
    ``(stats, alloc)``."""
    from light_transport_tpu_torch.integrators.path_tracer import (
        _generator,
        _pixel_camera_rays,
        trace_paths,
    )

    sum_rgb, sum_l, sum_l2, count = stats
    n_pix = count.shape[0]
    dt = scene.camera.dtype

    # a pixel's priority: the MSE gain of one more sample, var / n^2, on
    # the display-clipped luminance (an emitter's raw variance would take
    # the budget); round 0 (every count 0) is uniform
    n = count.to(dt)
    safe_n = torch.clamp(n, min=1.0)
    var = torch.clamp(sum_l2 / safe_n - (sum_l / safe_n) ** 2, min=0.0)
    gain = torch.where(count > 0, var / (safe_n * safe_n), 0.0)
    gain_sum = gain.sum()
    norm = torch.clamp(gain_sum, min=1e-30)
    w = _EXPLORE / n_pix + (1.0 - _EXPLORE) * gain / norm
    w = torch.where(gain_sum > 0, w, torch.ones_like(w) / n_pix)
    alloc = _integer_alloc(w, budget)

    # lane -> pixel by the allocation's prefix sum; a lane's rank within
    # its pixel continues that pixel's samples at its count
    cum = torch.cumsum(alloc, dim=0)
    lane = torch.arange(budget, dtype=cum.dtype, device=cum.device)
    pixel = torch.searchsorted(cum, lane, right=True)
    start = cum[pixel] - alloc[pixel]
    sample = count[pixel] + (lane - start)

    u_lens = None
    if cfg.sampler == "sobol":
        bits = qmc.seed_bits(seed)
        u_aa, uniforms = qmc.lane_uniforms(bits, pixel, sample,
                                           cfg.max_depth, dtype=dt)
        if cfg.aperture > 0.0:
            u_lens = torch.stack(qmc.scrambled_pair(
                pixel, sample, qmc.LENS_PAIR, bits, dtype=dt), dim=-1)
    else:
        gen = _generator(scene, rng.fold_seed(seed, round_idx))
        u_aa = torch.rand((budget, 2), generator=gen, dtype=dt,
                          device=gen.device)
        uniforms = rng.path_uniforms(gen, budget, cfg.max_depth, dtype=dt)
        if cfg.aperture > 0.0:
            u_lens = torch.rand((budget, 2), generator=gen, dtype=dt,
                                device=gen.device)

    origins, directions = _pixel_camera_rays(scene, cfg, pixel, u_aa, u_lens)
    radiance, _ = trace_paths(scene, cfg, origins, directions, uniforms,
                              ray_chunk=ray_chunk)
    # the stats take the display-clipped luminance; the estimate (sum_rgb)
    # the raw radiance
    lum = (0.2126 * radiance[:, 0] + 0.7152 * radiance[:, 1]
           + 0.0722 * radiance[:, 2])
    lum = torch.clamp(lum, max=1.0)
    sum_rgb.index_add_(0, pixel, radiance)
    sum_l.index_add_(0, pixel, lum)
    sum_l2.index_add_(0, pixel, lum * lum)
    count.index_add_(0, pixel, torch.ones_like(pixel, dtype=count.dtype))
    return stats, alloc


def render_adaptive(scene, cfg: RenderConfig, seed: int = 0, rounds: int = 4,
                    ray_chunk: Optional[int] = None,
                    return_counts: bool = False):
    """Render with the budget ``H * W * spp`` spent over ``rounds``
    variance-driven rounds (``cfg.spp`` must be divisible by ``rounds``).
    Returns the ``(H, W, 3)`` image clipped to [0, 1], and the per-pixel
    sample counts ``(H, W)`` when ``return_counts``."""
    from light_transport_tpu_torch.integrators.path_tracer import (
        _check_config,
    )

    _check_config(cfg)
    if cfg.spp % rounds != 0:
        raise ValueError(
            f"cfg.spp ({cfg.spp}) must be divisible by rounds ({rounds})")
    n_pix = cfg.height * cfg.width
    budget = n_pix * (cfg.spp // rounds)
    kw = dict(dtype=scene.camera.dtype, device=scene.device)
    stats = (torch.zeros((n_pix, 3), **kw), torch.zeros((n_pix,), **kw),
             torch.zeros((n_pix,), **kw),
             torch.zeros((n_pix,), dtype=torch.int32, device=scene.device))
    for r in range(rounds):
        stats, _ = _round(scene, cfg, seed, budget, stats, r, ray_chunk)
    sum_rgb, _, _, count = stats
    img = sum_rgb / torch.clamp(count, min=1).to(sum_rgb.dtype)[:, None]
    image = torch.clamp(img, 0.0, 1.0).reshape(cfg.height, cfg.width, 3)
    if return_counts:
        return image, count.reshape(cfg.height, cfg.width)
    return image
