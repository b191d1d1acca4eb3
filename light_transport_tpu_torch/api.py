"""Public API: the photon engine and the camera render."""

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
    """Render a camera image ``(H, W, 3)`` on the scene's device with the
    NEE path tracer; ``cfg.fresnel_mode="split"`` renders through the
    both-branch Fresnel tracer.  The other integrators of the JAX package
    (adaptive, Whitted, BDPT) are not ported yet (ROADMAP)."""
    if integrator != "path":
        raise NotImplementedError(
            f"integrator={integrator!r} is not ported yet (ROADMAP); the "
            "port renders integrator='path'")
    from light_transport_tpu_torch.integrators import path_tracer

    cfg = cfg or RenderConfig()
    render_one = (path_tracer.render_image_split
                  if cfg.fresnel_mode == "split"
                  else path_tracer.render_image)
    return render_one(scene, cfg, cfg.seed if seed is None else seed,
                      ray_chunk=ray_chunk)
