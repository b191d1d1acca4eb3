"""Runnable presets: callables returning ``(medium, cfg)`` for the photon
engine or ``(scene, cfg)`` for the render, as the JAX package's presets
do.  The point-light and hard-shadow render presets belong to a later
slice (ROADMAP)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from light_transport_tpu_torch.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu_torch.scene.cornell import cornell_box_scene
from light_transport_tpu_torch.scene.medium import LayeredMedium


def demo_homogeneous(device="cuda"):
    """~1e5 photons, homogeneous absorbing/scattering medium, reflectance +
    fluence tallies."""
    medium = LayeredMedium.build(
        [MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)], device=device)
    cfg = PhotonRunConfig(n_photons=100_000, nr=64, nz=64, dr=0.02, dz=0.02)
    return medium, cfg


def hg_sweep(g_values=(0.0, 0.5, 0.9), mu_a_values=(0.1, 1.0, 10.0),
             mu_s_values=(10.0, 90.0), device="cuda"):
    """Anisotropic Henyey-Greenstein sweep in a semi-infinite, index-matched
    medium, 1e5 photons a configuration.  Yields ``(label, medium, cfg)``
    triples, g slowest and mu_s fastest."""
    for g in g_values:
        for mu_a in mu_a_values:
            for mu_s in mu_s_values:
                medium = LayeredMedium.build(
                    [MediumConfig(mu_a=mu_a, mu_s=mu_s, g=g, n=1.0)],
                    device=device)
                cfg = PhotonRunConfig(n_photons=100_000, nr=64, nz=64,
                                      dr=0.02, dz=0.02)
                yield f"g={g}_mua={mu_a}_mus={mu_s}", medium, cfg


def multilayer_mismatch(device="cuda"):
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


def full_scale(device="cuda"):
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


def mesh_scene(device="cuda"):
    """The LTS Cornell + cone scene at its notebook settings, with a BVH
    (the per-surface detector configuration)."""
    scene, cfg = cornell_box_scene(width=150, height=150, spp=12, max_depth=4,
                                   device=device)
    return scene.with_bvh(), cfg


def lts_scene(device="cuda", **kw):
    """The flagship notebook scene: Cornell box, glass cone, area light."""
    return cornell_box_scene(device=device, **kw)


def glass_scene(width=100, height=100, spp=4, max_depth=3, device="cuda"):
    """The whisky glass (body, liquid, ice; 414 triangles with the box)
    standing in the Cornell box, rendered with emission_mode="nee" since
    specular chains carry most of its light."""
    from light_transport_tpu_torch.scene.geometry import concat_meshes
    from light_transport_tpu_torch.scene.glass import (
        design_glass,
        glass_materials,
    )
    from light_transport_tpu_torch.scene.cornell import cornell_materials
    from light_transport_tpu_torch.scene.material import MaterialTable
    from light_transport_tpu_torch.scene.scene import Scene

    base, cfg = cornell_box_scene(width=width, height=height, spp=spp,
                                  max_depth=max_depth, include_cone=False,
                                  device=device)
    cfg = dataclasses.replace(cfg, emission_mode="nee")
    dim = 7.5
    # scale the tumbler into the box and stand its base on the floor
    glass = design_glass(mat_offset=5, device=device).scaled(0.85)
    y_min = float(glass.vertices()[..., 1].min())
    glass = glass.translated((0.0, -dim + 0.01 - y_min, 0.0))
    mats = MaterialTable.build(cornell_materials() + glass_materials(),
                               device=device)
    mesh = concat_meshes([base.mesh, glass])
    scene = Scene.build(mesh, mats, camera=[0.0, 0.0, dim + 0.5]).with_bvh()
    return scene, cfg


PRESETS: Dict[str, Callable] = {
    "demo": demo_homogeneous,
    "multilayer": multilayer_mismatch,
    "mesh": mesh_scene,
    "full_scale": full_scale,
    "lts": lts_scene,
    "glass": glass_scene,
}
