"""Public API: the photon engine and the camera render (path tracer,
adaptive path tracer, Whitted and BDPT)."""

from __future__ import annotations

from typing import Optional

from light_transport_tpu_torch.core.config import PhotonRunConfig, RenderConfig


def simulate(medium, run_cfg: Optional[PhotonRunConfig] = None,
             seed: int = 0, device=None):
    """Run the photon Monte Carlo engine (the plain-torch superstep engine)
    on a layered medium; returns the tallies (reflectance, transmittance,
    fluence, ...).  ``device`` defaults to the medium's."""
    from light_transport_tpu_torch.transport.photon import simulate_photons

    run_cfg = run_cfg or PhotonRunConfig()
    return simulate_photons(medium, run_cfg, seed, device=device)


def render(scene, cfg: Optional[RenderConfig] = None, seed: int = 0,
           integrator: str = "path", ray_chunk: Optional[int] = None):
    """Render a camera image ``(H, W, 3)`` on the scene's device.
    ``integrator``: ``"path"``, the NEE path tracer
    (``cfg.fresnel_mode="split"`` renders through the both-branch Fresnel
    tracer), ``"adaptive"``, the path tracer with the budget spent over
    variance-driven rounds, ``"whitted"``, the Whitted ray tracer (one ray
    a pixel), or ``"bdpt"``, bidirectional path tracing with MIS (area,
    point and mixed light families, light tracing on).  The Sobol'
    sampler and the thin lens apply to the path and adaptive integrators
    only.  The control-variates render has its own entry,
    ``integrators.control_variates.render_cv`` (iid draws: it refuses the
    Sobol' sampler)."""
    if integrator not in ("path", "adaptive", "whitted", "bdpt"):
        raise ValueError(f"unknown integrator: {integrator}")
    cfg = cfg or RenderConfig()
    if integrator in ("whitted", "bdpt"):
        # Whitted traces one deterministic ray a pixel; BDPT draws its own
        # streams, and its camera importance assumes a pinhole
        if cfg.sampler != "uniform":
            raise ValueError(
                f"sampler={cfg.sampler!r} applies to the path tracer only "
                f"(got integrator={integrator!r})")
        if cfg.aperture > 0.0:
            raise ValueError(
                "aperture > 0 (thin-lens DOF) is supported by the path and "
                f"adaptive integrators only (got integrator={integrator!r})")
    if cfg.emission_mode == "mis" and cfg.nee_mode != "one":
        raise ValueError(
            "emission_mode='mis' requires nee_mode='one' (the power "
            "heuristic needs the NEE sampling density)")
    seed = cfg.seed if seed is None else seed
    if integrator == "adaptive":
        from light_transport_tpu_torch.integrators.adaptive import (
            render_adaptive,
        )

        if cfg.fresnel_mode == "split":
            raise ValueError(
                "integrator='adaptive' supports fresnel_mode='stochastic' "
                "only (its rounds trace through trace_paths)")
        # the largest round count of 4 or fewer that divides spp
        rounds = next(r for r in (4, 3, 2, 1) if cfg.spp % r == 0)
        return render_adaptive(scene, cfg, seed, rounds=rounds,
                               ray_chunk=ray_chunk)
    if integrator == "whitted":
        from light_transport_tpu_torch.integrators.whitted import (
            render_whitted,
        )

        return render_whitted(scene, cfg, seed, ray_chunk=ray_chunk)
    if integrator == "bdpt":
        from light_transport_tpu_torch.integrators.bdpt import render_bdpt

        return render_bdpt(scene, cfg, seed, ray_chunk=ray_chunk)
    from light_transport_tpu_torch.integrators import path_tracer

    render_one = (path_tracer.render_image_split
                  if cfg.fresnel_mode == "split"
                  else path_tracer.render_image)
    return render_one(scene, cfg, seed, ray_chunk=ray_chunk)
