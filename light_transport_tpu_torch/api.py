"""Public API of the photon slice."""

from __future__ import annotations

from typing import Optional

from light_transport_tpu_torch.core.config import PhotonRunConfig


def simulate(medium, run_cfg: Optional[PhotonRunConfig] = None,
             seed: int = 0, device=None):
    """Run the photon Monte Carlo engine (the plain-torch superstep engine)
    on a layered medium; returns the tallies (reflectance, transmittance,
    fluence, ...).  ``device`` defaults to the medium's."""
    from light_transport_tpu_torch.transport.photon import simulate_photons

    run_cfg = run_cfg or PhotonRunConfig()
    return simulate_photons(medium, run_cfg, seed, device=device)
