"""Runnable photon presets: zero-argument callables returning
``(medium, cfg)`` (the photon configurations of the JAX package's presets;
the render presets belong to slices not yet ported)."""

from __future__ import annotations

from typing import Callable, Dict

from light_transport_tpu_torch.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu_torch.scene.medium import LayeredMedium


def demo_homogeneous(device="cpu"):
    """~1e5 photons, homogeneous absorbing/scattering medium, reflectance +
    fluence tallies."""
    medium = LayeredMedium.build(
        [MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)], device=device)
    cfg = PhotonRunConfig(n_photons=100_000, nr=64, nz=64, dr=0.02, dz=0.02)
    return medium, cfg


def multilayer_mismatch(device="cpu"):
    """Layered slab with refractive-index mismatch (Fresnel/TIR at the
    interfaces, layered fluence depth profile)."""
    medium = LayeredMedium.build(
        [
            MediumConfig(mu_a=1.0, mu_s=100.0, g=0.9, n=1.4, thickness=0.1),
            MediumConfig(mu_a=1.0, mu_s=10.0, g=0.0, n=1.0, thickness=0.1),
            MediumConfig(mu_a=2.0, mu_s=10.0, g=0.7, n=1.37, thickness=0.2),
        ],
        n_above=1.0, n_below=1.0, device=device)
    cfg = PhotonRunConfig(n_photons=200_000, nr=64, nz=100, dr=0.01, dz=0.005)
    return medium, cfg


def full_scale(device="cpu"):
    """1e8 photons into a 512x512 (r,z) grid, a 512x512 exit-detector image
    and a 128^3 absorption volume (0.2 mm pitch, +/-1.28 cm around the beam
    axis and 2.56 cm deep).  The spatial tallies are strided (unbiased
    stratified thinning): the (r,z) grid takes every 32nd step's deposit,
    the volume every 64th; exits, the detector and all counters are exact
    every step.  Dead lanes respawn at every stride window."""
    medium = LayeredMedium.build(
        [MediumConfig(mu_a=0.5, mu_s=50.0, g=0.9, n=1.37)], device=device)
    cfg = PhotonRunConfig(n_photons=100_000_000, nr=512, nz=512,
                          dr=0.005, dz=0.005,
                          detector_nx=512, detector_extent=1.28,
                          vol_nx=128, vol_ny=128, vol_nz=128,
                          vol_dx=0.02, vol_dy=0.02, vol_dz=0.02,
                          tally_stride=32, vol_stride=64,
                          respawn_windows=1)
    return medium, cfg


PRESETS: Dict[str, Callable] = {
    "demo": demo_homogeneous,
    "multilayer": multilayer_mismatch,
    "full_scale": full_scale,
}
